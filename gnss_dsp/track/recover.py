"""Unknown-code recovery: accumulate data-wiped samples into per-chip
bins while tracking with a known reference signal — how the reference
captured the B2b memory codes (track-beidou-b2bi.py:46-53).

After `warmup` blocks, each block's carrier-wiped samples are added into
a [code_length] accumulator at their code-phase bin, sign-corrected by
the prompt's real part (data-bit wipe); the recovered chips are the sign
of the real accumulator.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gnss_dsp.ops import nco


class CodeRecovery:
    def __init__(self, code_length: int, warmup_blocks: int = 200):
        self.code_length = int(code_length)
        self.warmup = int(warmup_blocks)
        self.acc_re = jnp.zeros(self.code_length, jnp.float32)
        self.acc_im = jnp.zeros(self.code_length, jnp.float32)
        self.blocks = 0

    def update(self, x_wiped, code_p: float, cf: float, p_prompt_re: float):
        """x_wiped: split-complex carrier-wiped block; code_p/cf as in the
        tracking loop; sign from the prompt's I arm (b2bi.py:47-51)."""
        self.blocks += 1
        if self.blocks <= self.warmup:
            return
        s = 1.0 if p_prompt_re > 0 else -1.0
        ar, ai = nco.accum_code_bins(
            (x_wiped[0] * s, x_wiped[1] * s),
            jnp.float32(code_p), jnp.float32(cf), self.code_length)
        self.acc_re = self.acc_re + ar
        self.acc_im = self.acc_im + ai

    def chips(self) -> np.ndarray:
        """Recovered +-1 chips (int8)."""
        return np.where(np.asarray(self.acc_re) >= 0, 1, -1).astype(np.int8)

    def confidence(self) -> float:
        """Mean |bin| in units of its std — rough chip-decision SNR."""
        a = np.abs(np.asarray(self.acc_re))
        return float(a.mean() / (a.std() + 1e-12))
