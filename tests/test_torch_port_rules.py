"""The port stands alone and chip_smoke.py's phases run: no module of
vitvs_tpu_torch nor chip_smoke.py imports JAX or vitvs_tpu; no CUDA source
includes PyTorch's headers and nothing uses torch.utils.cpp_extension; the
phase functions of chip_smoke.py (the bf16 main path and the int8 serving
step) run at tiny size on the CPU (plain versions, which is what the kernel
wrappers take for CPU tensors)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from vitvs_tpu_torch.harness.pipeline import ServoModel
from vitvs_tpu_torch.io_bridge.config import VSConfig, load_config
from vitvs_tpu_torch.models import vit as tvit

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "vitvs_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "vitvs_tpu", "flax", "optax", "orbax"), (path, mod)


def test_kernels_use_plain_c_interface():
    cu = sorted((REPO / "vitvs_tpu_torch" / "csrc").glob("*.cu"))
    assert [p.name for p in cu] == ["attention.cu", "attention_f32.cu", "attention_fast.cu",
                                    "attn_int8.cu", "matcher.cu"]
    for p in cu:
        text = p.read_text()
        assert "torch/extension.h" not in text and "ATen" not in text, p
        assert 'extern "C"' in text, p
    for p in PORT_FILES:
        assert "cpp_extension" not in p.read_text(), p


def test_chip_smoke_config_is_config_yaml():
    assert chip_smoke.reference_config() == load_config(REPO / "configs" / "config.yaml")


def test_chip_smoke_serving_config_is_config_vitb_518():
    assert chip_smoke.serving_config() == load_config(REPO / "configs" / "config_vitb_518.yaml")


def test_chip_smoke_kernel_phase_runs_on_cpu():
    assert chip_smoke.check_attention("cpu", shape=(1, 37, 2, 64)) == 0.0
    assert chip_smoke.check_attention("cpu", shape=(1, 37, 2, 64), dtype=torch.float32,
                                      tol=chip_smoke.ATTN_F32_TOL) == 0.0
    assert chip_smoke.check_matcher("cpu", shape=(50, 72)) == 0.0
    chip_smoke.check_matcher_exact("cpu", t=40, d=64)
    assert chip_smoke.check_matcher_bf16("cpu", shapes=[(50, 50, 72), (1, 3, 10), (9, 33, 20)]) == 0.0
    assert chip_smoke.check_attention_fast("cpu", shape=(1, 37, 2, 64)) == 0.0
    assert chip_smoke.check_int8_attention("cpu", shape=(1, 37, 2, 64)) == 0.0
    assert chip_smoke.check_quant_probe("cpu", shape=(1, 37, 2, 64)) == {
        "rows": 148, "card_quant_th_scale_diffs": 0}


def test_chip_smoke_bounds_follow_the_shapes():
    ms, by = chip_smoke.attention_bound_ms()
    assert by == "bytes" and ms == pytest.approx(4 * 485 * 6 * 64 * 2 / 3.35e12 * 1e3)  # q, k, v, o in bf16
    # the f32 step's exact attention: f32 FMA outside the tensor cores
    ms, by = chip_smoke.attention_bound_ms(f32=True)
    assert by == "operations" and ms == pytest.approx(4 * 6 * 485 ** 2 * 64 / 67e12 * 1e3)
    assert ms == pytest.approx(5.39e-3, rel=1e-3)
    # ... and f32 accurate on the tensor cores: three TF32 passes (split precision)
    ms, by = chip_smoke.attention_bound_ms(f32=True, tensor_cores=True)
    assert by == "operations" and ms == pytest.approx(3 * 4 * 6 * 485 ** 2 * 64 / 495e12 * 1e3)
    assert ms == pytest.approx(2.19e-3, rel=1e-2)
    ms, by = chip_smoke.attention_bound_ms(chip_smoke.SERVE_ATTN_SHAPE, f32=True,
                                           tensor_cores=True)
    assert by == "operations" and ms == pytest.approx(3 * 4 * 12 * 1370 ** 2 * 64 / 495e12 * 1e3)
    ms, by = chip_smoke.matcher_bound_ms()
    assert by == "operations" and ms == pytest.approx(2 * 484 ** 2 * 3456 / 67e12 * 1e3)
    # bf16 mode: bf16 rows read and the quartet written, on the bf16 tensor cores
    ms, by = chip_smoke.matcher_bound_ms(bf16=True)
    assert by == "bytes" and ms == pytest.approx((2 * 484 * 3456 * 2 + 2 * 484 * 8) / 3.35e12 * 1e3)
    # the serving kernels at ViT-B/14 @ 518: both bounded by operations
    ms, by = chip_smoke.attention_bound_ms(chip_smoke.SERVE_ATTN_SHAPE)
    assert by == "operations" and ms == pytest.approx(4 * 12 * 1370 ** 2 * 64 / 989e12 * 1e3)
    ms, by = chip_smoke.int8_attention_bound_ms()
    mm = 2 * 12 * 1370 ** 2 * 64
    assert by == "operations" and ms == pytest.approx((mm / 1979e12 + mm / 989e12) * 1e3)


def test_chip_smoke_main_path_runs_tiny_on_cpu():
    """The main-path phase with a tiny 2-block ViT on the CPU: both runs go
    through the plain versions, so they agree exactly and no kernel counts
    a launch."""
    cfg = VSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84,
                   num_pairs=12, layer=1, model_name="tiny", pinv_mode="dls")
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=96, depth=2, num_heads=3, pos_grid=5,
                          gelu_approx=True, model_name="tiny")
    model = ServoModel(vit=vcfg, cfg=cfg, compute_dtype=torch.bfloat16, device="cpu")
    net = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                        layerscale=1.0).cast_blocks(torch.bfloat16).eval()
    summary = chip_smoke.run_main_path(net, cfg, model)
    assert summary["launches"] == {"attention": 0, "attention_f32": 0, "attention_fast": 0,
                                   "attn_int8": 0, "matcher": 0, "matcher_bf16": 0}
    assert summary["differing_pairs"] == [0] * chip_smoke.N_STEPS
    assert summary["desc_rel_err"] == 0.0 and summary["twist_max_abs_err"] == 0.0
    assert summary["steps_compared"] == chip_smoke.N_STEPS
    assert len(summary["body_twist_last"]) == 6 and np.isfinite(summary["body_twist_last"]).all()


def test_chip_smoke_f32_step_runs_tiny_on_cpu():
    """Phase 3c with a tiny 2-block ViT on the CPU: the f32 step (f32
    blocks and descriptors, exact GELU) through the plain versions, held at
    the f32 tolerances."""
    cfg = VSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84,
                   num_pairs=12, layer=1, model_name="tiny", pinv_mode="dls")
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=96, depth=2, num_heads=3, pos_grid=5,
                          gelu_approx=False, model_name="tiny")
    model = ServoModel(vit=vcfg, cfg=cfg, compute_dtype=torch.float32, device="cpu")
    net = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                        layerscale=1.0).eval()
    summary = chip_smoke.run_main_path(net, cfg, model, tol=chip_smoke.F32_TOL)
    assert summary["launches"] == dict.fromkeys(summary["launches"], 0)
    assert summary["differing_pairs"] == [0] * chip_smoke.N_STEPS
    assert summary["desc_rel_err"] == 0.0 and summary["twist_max_abs_err"] == 0.0
    assert np.isfinite(summary["body_twist_last"]).all()
    # the full-size f32 step chip_smoke.py drives: config.yaml's settings in f32
    net32, model32 = chip_smoke.f32_step(chip_smoke.reference_config(), "cpu")
    assert model32.compute_dtype == torch.float32 and not model32.vit.gelu_approx
    assert net32.compute_dtype == torch.float32 and model32.vit.embed_dim == 384


@pytest.mark.parametrize("variant", sorted(chip_smoke.VARIANTS))
def test_chip_smoke_serving_path_runs_tiny_on_cpu(variant):
    """The int8 serving phase with a tiny 2-block ViT on the CPU, bf16:
    calibration, then both runs through the plain versions."""
    cfg = VSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84,
                   num_pairs=12, layer=1, model_name="tiny", pinv_mode="dls")
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=128, depth=2, num_heads=2, pos_grid=5,
                          gelu_approx=True, model_name="tiny")
    fnet = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                         layerscale=1.0).eval()
    summary, qnet, model = chip_smoke.run_serving_path(fnet, cfg, variant, "cpu", vit=vcfg)
    assert model.quantized and model.source_quantized_bins
    assert model.vit.quant_attn == chip_smoke.VARIANTS[variant][0]
    assert qnet.blocks[0].act_scales is not None and qnet.compute_dtype == torch.bfloat16
    assert summary["launches"] == dict.fromkeys(summary["launches"], 0)
    assert summary["differing_pairs"] == [0] * chip_smoke.N_STEPS
    assert summary["desc_rel_err"] == 0.0 and summary["twist_max_abs_err"] == 0.0
    assert np.isfinite(summary["body_twist_last"]).all()


def test_chip_smoke_frames_are_shifted_texture():
    cfg = VSConfig(u_max=64, v_max=48)
    goal, frames, depth = chip_smoke.make_frames(cfg, shifts=[(0, 0), (2, 3)])
    assert goal.shape == (48, 64, 3) and goal.dtype == np.uint8 and depth.shape == (48, 64)
    np.testing.assert_array_equal(frames[0], goal)
    np.testing.assert_array_equal(frames[1][:-2, :-3], goal[2:, 3:])
