"""Fault 3.5 (ROADMAP.md): the port's int8 quantizers against ``jax.jit``
of the reference functions, bit for bit.

The reference divides by 127.0 inside its jitted step, and XLA rewrites
that as a multiply by f32(1/127); with an extra factor after it
(``_quant_th``'s Q path) it folds both constants into one.  The port
computes the same products on every device.  Each case first shows that its
input tells the two arithmetics apart (a true division by 127 gives other
scales in at least 1% of the rows), then holds the port's int8 values and
scales equal to the jitted reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.match import binned as jbinned
from vitvs_tpu.models import quant as jquant
from vitvs_tpu.ops import attn_int8 as jattn_int8
from vitvs_tpu_torch.match import binned as tbinned
from vitvs_tpu_torch.models import quant as tquant
from vitvs_tpu_torch.ops import attn_int8 as tattn_int8

Q_EXTRA = float(np.log2(np.e) / 8)     # hd^-0.5 log2(e) at hd = 64


def _inputs(shape, dtype, seed):
    """The same seeded values as a JAX array and a torch tensor of ``dtype``,
    with a zero row, a row of large values and a row below the 1e-12 floor."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[..., 0, :] = 0
    x[..., 1, :] *= 1000
    x[..., 2, :] *= 1e-20
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32)))
    return jx, tx.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _amax(tx: torch.Tensor, heads: int) -> torch.Tensor:
    """The clamped amax of each (row, head) group, f32."""
    return torch.clamp(tx.reshape(*tx.shape[:-1], heads, -1).abs().amax(-1).float(), min=1e-12)


# (name, shape, dtype, heads, extra): the shapes of ROADMAP.md fault 3.5's table
CASES = [
    ("quant_th_K", (1, 1370, 768), jnp.bfloat16, 12, 1.0),
    ("quant_th_Q", (1, 1370, 768), jnp.bfloat16, 12, Q_EXTRA),
    ("dyn_quant_act", (1, 1370, 768), jnp.bfloat16, 1, 1.0),
    ("quantize_rows_int8_f32", (1369, 6912), jnp.float32, 1, 1.0),
    ("quantize_rows_int8_bf16", (1369, 6912), jnp.bfloat16, 1, 1.0),
]


@pytest.mark.parametrize("name,shape,dtype,heads,extra", CASES, ids=[c[0] for c in CASES])
def test_quantizer_matches_jitted_reference_bit_for_bit(name, shape, dtype, heads, extra):
    jx, tx = _inputs(shape, dtype, seed=len(name))
    if name.startswith("quant_th"):
        ref = jax.jit(lambda a: jattn_int8._quant_th(a, heads, extra))(jx)
        got = tattn_int8._quant_th(tx, heads, extra)
    elif name == "dyn_quant_act":
        ref, got = jax.jit(jquant._dyn_quant_act)(jx), tquant._dyn_quant_act(tx)
    else:
        ref, got = jax.jit(jbinned.quantize_rows_int8)(jx), tbinned.quantize_rows_int8(tx)
    ref_q, ref_s = (np.asarray(r) for r in ref)
    bits = lambda s: np.ascontiguousarray(s, np.float32).view(np.int32)
    divided = (_amax(tx, heads) / 127.0 * extra).reshape(ref_s.shape).numpy()
    assert (bits(divided) != bits(ref_s)).mean() > 0.01     # the input shows the gap
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), ref_q)
    np.testing.assert_array_equal(bits(got[1].numpy()), bits(ref_s))


def test_quant_th_scale_factor_is_xlas_folded_constant():
    """The returned scales' factor: f32(1/127) alone for K, and
    f32(f32(1/127) * f32(extra)) for Q."""
    inv127 = np.float32(1 / 127)
    assert tattn_int8.INV127 == float(inv127)
    assert tattn_int8._scale_factor(1.0) == float(inv127)
    assert tattn_int8._scale_factor(Q_EXTRA) == float(inv127 * np.float32(Q_EXTRA))
