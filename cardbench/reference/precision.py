"""The precisions a reference computes in.

`F64` is the reference itself: every array in float64, no rounding. `TF32`
is the control, the nearest precision below the float32 (TF32 off) that
the configurations state: every array the reference stores between its
steps is rounded to TF32's 10 mantissa bits (round to nearest even on the
float32 bits), and the arithmetic between two roundings is float64, as a
program that accumulates in a wider type computes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def round_mantissa(x, bits: int) -> np.ndarray:
    """float64 array of the values nearest to `x` with `bits` explicit
    mantissa bits and float32's exponent range."""
    x = np.asarray(x, np.float64)
    a = np.ascontiguousarray(x.astype(np.float32)).reshape(-1)
    u = a.view(np.uint32).astype(np.uint64)
    drop = 23 - bits
    half = (1 << (drop - 1)) - 1
    r = ((u + half + ((u >> drop) & 1)) & (0xFFFFFFFF ^ ((1 << drop) - 1))
         ).astype(np.uint32)
    out = r.view(np.float32).astype(np.float64)
    # NaN and inf keep their class
    return np.where(np.isfinite(a), out, a.astype(np.float64)).reshape(x.shape)


@dataclass(frozen=True)
class Precision:
    name: str
    bits: int | None = None     # explicit mantissa bits; None: float64

    def q(self, x) -> np.ndarray:
        """`x` as this precision stores it (always a float64 array)."""
        if self.bits is not None:
            return round_mantissa(x, self.bits)
        return np.asarray(x, np.float64)


F64 = Precision("f64")
TF32 = Precision("tf32", 10)

BY_NAME = {"f64": F64, "tf32": TF32}
