"""``ViTConfig.ln_f32`` / ``softmax_f32`` of the port against vitvs_tpu, and
``scripts/port_measure.py`` (the port's ``scripts/measure.py``) on the CPU.

The flags change bf16 arithmetic only.  Under ``jax.jit`` on the CPU, XLA
may keep f32 between the reference's bf16 operations (excess precision), so
the jitted reference's bf16 softmax is often its f32 one: the forward with
both flags off is held to ``jax.jit`` of the reference at the bf16
tolerances of the other bf16 tests (per-token cosine, mean and largest
difference), closer to it than the port's forward with the flags on (the
LayerNorm flag's statistics are visible there); each flag's arithmetic is
held to the reference's bf16 operations run one by one (eager JAX, each
rounding to bf16); each flag moves the port's output wherever the
reference reads it; and the Pallas routes ignore it.
"""

import dataclasses
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.models import quant as jq
from vitvs_tpu.models import vit as jvit
from vitvs_tpu_torch.models import quant as tq
from vitvs_tpu_torch.models import vit as tvit
from vitvs_tpu_torch.models.convert import from_jax_params, from_jax_quant_params
from vitvs_tpu_torch.ops import attention as tatt

VIT = dict(patch_size=14, embed_dim=128, depth=2, num_heads=2, pos_grid=5, stride=14,
           gelu_approx=True, model_name="tiny")
ON = dict(ln_f32=True, softmax_f32=True)
OFF = dict(ln_f32=False, softmax_f32=False)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    """Seeded weights with LayerScale near 1 and nonzero biases."""
    p = jax.tree.map(np.asarray, jvit.init_vit(jvit.ViTConfig(**VIT), jax.random.PRNGKey(3)))
    rs = np.random.default_rng(5)
    for n in ("ls1", "ls2"):
        p["blocks"][n] = rs.uniform(0.5, 1.5, p["blocks"][n].shape).astype(np.float32)
    for n in ("qkv_bias", "proj_bias", "fc1_bias", "fc2_bias", "norm1_bias"):
        p["blocks"][n] = 0.1 * rs.standard_normal(p["blocks"][n].shape).astype(np.float32)
    return p


IMG = np.random.default_rng(9).standard_normal((2, 70, 70, 3)).astype(np.float32)
CALIB = np.random.default_rng(1).standard_normal((2, 70, 70, 3)).astype(np.float32)


def _float_port(params, kw, flags, dtype=torch.bfloat16) -> np.ndarray:
    net = tvit.ViT(tvit.ViTConfig(**VIT, **kw, **flags))
    net.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        return tvit.vit_features(net.eval().cast_blocks(dtype), torch.from_numpy(IMG),
                                 1).float().numpy()


def _float_jax(params, kw, flags) -> np.ndarray:
    cfg = jvit.ViTConfig(**VIT, **kw, **flags)
    run = jax.jit(lambda p, x: jvit.vit_features(p, cfg, x, layer=1, compute_dtype=jnp.bfloat16))
    return np.asarray(run(params, jnp.asarray(IMG)), np.float32)


def _mean_rel(a, b) -> float:
    return float(np.abs(a - b).mean() / np.abs(b).max())


def _hold_bf16(out, ref, mean_tol):
    """The bf16 forwards of the two packages: every token's cosine at least
    0.9999, the mean |diff| within ``mean_tol`` and the largest within 2e-2
    of the output scale (bf16 rounds at other points in each: one bf16 ulp
    of an O(1) output is 2^-8 = 4e-3)."""
    cos = (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.9999, cos.min()
    assert _mean_rel(out, ref) <= mean_tol
    assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()


# the float ViT's softmax paths: the exact one ('xla'), pooled K/V, sqrelu scores
FLOAT_PATHS = {"xla": dict(), "pooled": dict(kv_pool=2), "sqrelu": dict(attn_score="sqrelu")}


@pytest.mark.parametrize("path", sorted(FLOAT_PATHS))
def test_float_vit_fast_math_matches_jitted_reference(path):
    """Both flags off, bf16, against jax.jit of the reference: held as
    :func:`_hold_bf16` (mean within 5e-4), and closer to it than the port's
    forward with both flags on (the flags reach the arithmetic)."""
    params, kw = _params(), FLOAT_PATHS[path]
    ref = _float_jax(params, kw, OFF)
    out, out_on = _float_port(params, kw, OFF), _float_port(params, kw, ON)
    _hold_bf16(out, ref, 5e-4)
    assert _mean_rel(out, ref) < _mean_rel(out_on, ref)


@pytest.mark.parametrize("flag", ["ln_f32", "softmax_f32"])
@pytest.mark.parametrize("path", sorted(FLOAT_PATHS))
def test_each_flag_moves_the_float_vit_and_f32_is_unchanged(path, flag):
    """Each flag alone changes the bf16 forward (nonzero gap) on every path
    where the reference reads it; the defaults are the forward as it was;
    in f32 neither flag changes anything (f32 statistics and logits are
    what both settings compute there)."""
    params, kw = _params(), FLOAT_PATHS[path]
    off = {**ON, flag: False}
    assert not np.array_equal(_float_port(params, kw, off), _float_port(params, kw, ON))
    assert np.array_equal(_float_port(params, kw, {}), _float_port(params, kw, ON))
    f32 = torch.float32
    assert np.array_equal(_float_port(params, kw, off, f32), _float_port(params, kw, ON, f32))


@pytest.mark.parametrize("mode", ["none", "nomax", "pv", "relu"])
def test_int8_vit_fast_math_matches_jitted_reference(mode):
    """The int8 ViT (static scales calibrated by the reference with both
    flags off, the same int8 weights on both sides), bf16: held as
    :func:`_hold_bf16` (mean within 1e-3: int8 activations near a rounding
    tie move by a step) and closer to the reference than the port with the
    flags on."""
    kw = dict(quant_attn="none", attn_score="relu") if mode == "relu" else dict(quant_attn=mode)
    jcfg = jvit.ViTConfig(**VIT, **kw, **OFF)
    qp = jax.tree.map(np.asarray, jq.quantize_vit_params(
        _params(), cfg=jcfg, calib_images=jnp.asarray(CALIB), layer=1,
        compute_dtype=jnp.bfloat16))
    ref = np.asarray(jax.jit(lambda q, x: jq.vit_features_quant(
        q, jcfg, x, layer=1, compute_dtype=jnp.bfloat16))(qp, jnp.asarray(IMG)), np.float32)

    def port(flags):
        qnet = from_jax_quant_params(qp, tvit.ViTConfig(**VIT, **kw, **flags), torch.bfloat16)
        with torch.no_grad():
            return tq.vit_features_quant(qnet, torch.from_numpy(IMG), 1).float().numpy()

    out, out_on = port(OFF), port(ON)
    _hold_bf16(out, ref, 1e-3)
    assert _mean_rel(out, ref) < _mean_rel(out_on, ref)
    assert not np.array_equal(port({**ON, "ln_f32": False}), out_on)
    if mode == "none":       # the one int8 mode whose softmax the flag changes
        assert not np.array_equal(port({**ON, "softmax_f32": False}), out_on)


def test_pallas_routes_ignore_softmax_f32():
    """'pallas' and 'fast' ignore softmax_f32 (the reference's Pallas
    route), on the float and the int8 ViT: bit for bit with the flag on;
    'auto' off the card reads it, as 'xla' does."""
    params = _params()
    for impl in ("pallas", "fast"):
        kw = dict(attn_impl=impl)
        assert np.array_equal(_float_port(params, kw, dict(softmax_f32=False)),
                              _float_port(params, kw, ON))
    assert np.array_equal(_float_port(params, dict(attn_impl="auto"), dict(softmax_f32=False)),
                          _float_port(params, dict(attn_impl="xla"), dict(softmax_f32=False)))
    qp = jax.tree.map(np.asarray, jq.quantize_vit_params(_params(), compute_dtype=jnp.bfloat16))
    outs = []
    for flag in (True, False):
        cfg = tvit.ViTConfig(**VIT, quant_attn="none", attn_impl="pallas", softmax_f32=flag)
        with torch.no_grad():
            outs.append(tq.vit_features_quant(from_jax_quant_params(qp, cfg, torch.bfloat16),
                                              torch.from_numpy(IMG), 1))
    assert torch.equal(*outs)


def _eager_bf16_softmax_attention(q, k, v):
    """The reference's plain attention with softmax_f32=False, its
    operations run one at a time in eager JAX (each rounding to bf16):
    logits = einsum(q, k) in bf16, times the scale, jax.nn.softmax's
    max, exp(x - max), sum and quotient, then P.V."""
    q, k, v = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    e = jnp.exp(logits - jnp.max(logits, axis=-1, keepdims=True))
    probs = e / jnp.sum(e, axis=-1, keepdims=True)
    out = jnp.einsum("bhqk,bkhd->bqhd", probs, v)
    return np.asarray(out.reshape(*out.shape[:2], -1), np.float32)


def test_bf16_softmax_arithmetic_matches_the_eager_reference():
    """The bf16 softmax against the reference's bf16 operations run one by
    one, at (1, 200, 4, 64), q and k of about +-3 (logits up to about 60).
    softmax_attention(softmax_f32=False) repeats the reference's roundings:
    within one bf16 ulp of the output scale (2^-8; equal but for the sum
    order), and nearer on average by 2x at least than its f32 softmax of the
    same bf16 logits.  The bf16-logits kernel's plain version (its scores
    rounded to bf16, the scale, bf16 probabilities; the max and the sums f32
    in one pass) within 2^-7, and nearer by 2x at least than the exact
    kernel's plain version (f32 scores: about 5x, seen)."""
    rs = np.random.default_rng(2)
    q, k = (3 * rs.standard_normal((1, 200, 4, 64)).astype(np.float32) for _ in range(2))
    v = rs.standard_normal((1, 200, 4, 64)).astype(np.float32)
    ref = _eager_bf16_softmax_attention(q, k, v)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    scale = np.abs(ref).max()
    err = lambda out: np.abs(out.float().numpy().reshape(ref.shape) - ref)  # noqa: E731
    for out, f32, tol in ((tvit.softmax_attention(*t, False), tvit.softmax_attention(*t), 2 ** -8),
                          (tatt.mha_attention_plain(*t, bf16_logits=True),
                           tatt.mha_attention_plain(*t), 2 ** -7)):
        assert err(out).max() <= tol * scale
        assert err(out).mean() <= 0.5 * err(f32).mean()


# ---------------------------------------------------------------------------
# scripts/port_measure.py
# ---------------------------------------------------------------------------


def _port_measure():
    spec = importlib.util.spec_from_file_location(
        "port_measure", os.path.join(REPO, "scripts", "port_measure.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY = ["--device", "cpu", "--size", "56", "--chain", "2", "--chain-short", "1", "--reps", "1"]


@pytest.mark.parametrize("variant", ["float", "quant_fast_math"])
@pytest.mark.parametrize("what", ["desc", "step", "match", "attn", "pre"])
def test_port_measure_runs_every_mode_on_the_cpu(what, variant, capsys):
    """Every mode of scripts/measure.py at ViT-B/14 @ 56 with short chains,
    float and int8 with static scales and --fast-math: the last line is
    measure.py's, the one before it names the device."""
    extra = [] if variant == "float" else ["--quant", "--static-scales", "--fast-math"]
    res = _port_measure().main([what, *TINY, *extra])
    lines = capsys.readouterr().out.strip().splitlines()
    quant = variant != "float"
    assert lines[-1] == res["line"] and lines[-2] == "device cpu (no card measured)"
    assert lines[-1].startswith(
        f"[measure] {what} (dinov2_vitb14@56, f32 params, attn=auto, quant={quant}, bin=True, "
        f"unroll=1): ")
    assert lines[-1].endswith(" Hz)") and " ms/iter  (" in lines[-1]
    assert set(res["chain_s"]) == {1, 2} and math.isfinite(res["ms_per_iter"])


def test_port_measure_flags_reach_the_model_and_unroll_is_refused(capsys):
    """--fast-math sets tanh GELU and both flags off, --softmax-bf16 the
    softmax flag alone, --attn the attention route; --unroll 2 (an XLA
    lowering choice) exits with an argparse error naming it; the default
    device is the card."""
    pm = _port_measure()
    model, _ = pm.build_model(pm.parse_args(["step", "--fast-math", "--attn", "xla",
                                             "--device", "cpu"]))
    assert (model.vit.gelu_approx, model.vit.ln_f32, model.vit.softmax_f32) == (True, False, False)
    assert model.vit.attn_impl == "xla" and model.device == "cpu"
    model, _ = pm.build_model(pm.parse_args(["step", "--softmax-bf16", "--device", "cpu"]))
    assert (model.vit.gelu_approx, model.vit.ln_f32, model.vit.softmax_f32) == (False, True, False)
    assert pm.parse_args(["pre"]).device == "cuda"
    with pytest.raises(SystemExit) as e:
        pm.parse_args(["step", "--unroll", "2"])
    assert e.value.code == 2 and "--unroll 2" in capsys.readouterr().err


def test_vitconfig_validates_the_flags():
    assert dataclasses.replace(tvit.ViTConfig(), ln_f32=False).ln_f32 is False
    for name in ("ln_f32", "softmax_f32"):
        with pytest.raises(ValueError, match=name):
            tvit.ViTConfig(**{name: 0})
