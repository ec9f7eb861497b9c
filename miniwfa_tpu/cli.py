"""test-mwf-compatible command-line driver.

Same flags, same PAF-like 10/11-column TSV output as the reference binary
(main.c:29-83), so golden outputs diff directly:

    python -m miniwfa_tpu.cli [options] <in1.fa> <in2.fa>

Reads the two (optionally gzipped) FASTA/FASTQ files in lockstep and aligns
record i of file 1 (target) against record i of file 2 (query).
"""

from __future__ import annotations

import getopt
import sys
import time

from . import Options, align_auto, align_chain, align_exact
from . import cigar as C
from .utils.cache import enable_compile_cache
from .utils.io import read_fastx

enable_compile_cache()

USAGE = """Usage: python -m miniwfa_tpu.cli [options] <in1.fa> <in2.fa>
Options:
  -c       generate CIGAR
  -p INT   step size (force -c; 0 to disable) [0]
  -u       apply the chaining heuristic
  -t       automatically choose between the exact and the chaining mode
  -l INT   min gapless length for chain filtering [30]
  -f INT   max k-mer occurrence [2]
  -a       mimic affine gap
  -e       mimic edit distance
  -B INT   batch size for device dispatch [64]
  -T       true per-pair timing: dispatch one pair at a time (the
           reference's per-pair semantics, main.c:12-17,83; costs the
           batching throughput)
  -K       (accepted for compatibility; no allocator to disable)
  -d       debug logging
Timing: by default stderr 'T' lines report the batch wall time amortized
per pair (batched device dispatch); -T makes them true per-pair walls.
"""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        # gnu_getopt permutes argv like the reference's ketopt
        # (ketopt.h:56-120): `cli t.fa q.fa -c` parses
        opts, args = getopt.gnu_getopt(argv, "cKdeTp:autl:f:B:")
    except getopt.GetoptError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    opt = Options()
    mode = 0
    batch_size = 64
    per_pair = False
    debug = False
    for o, a in opts:
        if o == "-c":
            opt = opt.replace(cigar=True)
        elif o == "-p":
            opt = opt.replace(cigar=True, step=int(a))
        elif o == "-a":
            opt = opt.as_single_affine()
        elif o == "-e":
            opt = opt.as_edit_distance()
        elif o == "-l":
            opt = opt.replace(min_len=int(a))
        elif o == "-f":
            opt = opt.replace(max_occ=int(a))
        elif o == "-u":
            mode = 1
        elif o == "-t":
            mode = 2
        elif o == "-B":
            batch_size = int(a)
        elif o == "-T":
            per_pair = True
        elif o == "-d":
            debug = True
    if per_pair:
        # -T wins regardless of flag order (-T -B 64 would otherwise
        # silently re-enable amortized batch timing): per-pair dispatch
        # => true per-pair T lines
        batch_size = 1
    if len(args) < 2:
        print(USAGE, file=sys.stderr)
        return 1

    it1, it2 = read_fastx(args[0]), read_fastx(args[1])
    pending = []

    def flush(pending):
        if not pending:
            return
        # per-pair timing (reference main.c:12-17,83 prints per-pair CPU
        # time): batched pairs share one device dispatch, so each pair's T
        # line reports the batch wall time amortized per pair; chain/auto
        # pairs run one-by-one and are timed individually
        if mode == 0:
            from .models.exact import align_batch as fn
        elif mode == 1:
            from .models.chain import align_chain_batch as fn
        else:
            from .models.auto import align_auto_batch as fn
        t0 = time.perf_counter()
        results = fn([(r1.seq, r2.seq) for r1, r2 in pending], opt)
        times = [(time.perf_counter() - t0) / len(pending)] * len(pending)
        for (r1, r2), r, dt in zip(pending, results, times):
            if opt.cigar and r.cigar is not None:
                C.assert_cigar(opt, r.cigar, len(r1.seq), len(r2.seq), r.s)
            row = (f"{r1.name}\t{len(r1.seq)}\t0\t{len(r1.seq)}\t+\t"
                   f"{r2.name}\t{len(r2.seq)}\t0\t{len(r2.seq)}\t{r.s}")
            if opt.cigar:
                row += "\t" + (r.cigar_str or "")
            print(row, flush=True)
            if debug:
                # analog of the reference's MWF_F_DEBUG traceback
                # bookkeeping line (miniwfa.c:367)
                ncig = len(r.cigar) if r.cigar is not None else 0
                print(f"D\t{r1.name}\t{r2.name}\ts={r.s}\tn_iter={r.n_iter}"
                      f"\tcigar_runs={ncig}", file=sys.stderr)
            print(f"T\t{r1.name}\t{r2.name}\t{dt:.3f}", file=sys.stderr)

    for r1, r2 in zip(it1, it2):
        pending.append((r1, r2))
        if len(pending) >= batch_size:
            flush(pending)
            pending = []
    flush(pending)
    return 0


if __name__ == "__main__":
    sys.exit(main())
