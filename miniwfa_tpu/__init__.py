"""miniwfa_tpu — a batched wavefront sequence-alignment framework in JAX.

A from-scratch JAX/XLA implementation of the WaveFront Alignment
algorithm under dual (two-piece) affine gap penalties, with the full
capability surface of lh3/miniwfa: exact high-memory alignment with packed
traceback, the exact low-memory stripe mode, heuristic k-mer chaining, and
an auto mode — batched, data-parallel across GPUs and hosts.

Public API (mirrors miniwfa.h:62-85):
    Options            — scoring / mode parameters (mwf_opt_t)
    align_exact        — mwf_wfa_exact
    align_chain        — mwf_wfa_chain
    align_auto         — mwf_wfa_auto
    Result             — mwf_rst_t
"""

from .options import Options
from .models.exact import Result, align_exact

__all__ = [
    "Options",
    "Result",
    "align_exact",
    "align_chain",
    "align_auto",
]
__version__ = "0.1.0"


def align_chain(ts, qs, opt: Options) -> Result:
    from .models.chain import align_chain as _f
    return _f(ts, qs, opt)


def align_auto(ts, qs, opt: Options) -> Result:
    from .models.auto import align_auto as _f
    return _f(ts, qs, opt)
