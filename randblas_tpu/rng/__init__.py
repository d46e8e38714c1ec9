"""Counter-based RNG core: Philox/Threefry generators, RNGState, transforms.

Counterpart of the reference's L2 layer (RandBLAS/base.hh RNGState,
RandBLAS/random_gen.hh generators; see SURVEY.md §1).
"""

from .state import RNGState, default_state, generator_info, DEFAULT_RNG
from .philox import philox4x32, philox2x32
from .threefry import threefry4x32, threefry2x32
from .transforms import u01, uneg11, boxmul_pair, boxmul_block, uneg11_block
from .bits import ctr_add64, mul32_wide, mul32_hi, rotl32

__all__ = [
    "RNGState", "default_state", "generator_info", "DEFAULT_RNG",
    "philox4x32", "philox2x32", "threefry4x32", "threefry2x32",
    "u01", "uneg11", "boxmul_pair", "boxmul_block", "uneg11_block",
    "ctr_add64", "mul32_wide", "mul32_hi", "rotl32",
]
