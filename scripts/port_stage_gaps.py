#!/usr/bin/env python3
"""Where the PyTorch port's bf16 servo step parts from the JAX package's,
stage by stage, on the trained ViT-S/14 (CPU; needs JAX and orbax).

    JAX_PLATFORMS=cpu python scripts/port_stage_gaps.py 308   # artifacts/ckpt_real308
    JAX_PLATFORMS=cpu python scripts/port_stage_gaps.py 518   # the exported ckpt_real518

On a frame the port renders of the poster scene (2 cm, -1 cm, 3 cm from the
goal pose), each stage is fed the reference's input and held against
``jax.jit`` of the reference stage: the preprocess (also with the divisions
by 255 and by the std written as reciprocal multiplies, as XLA computes them
under jit), the patch embedding, each of the 12 blocks, ``log_bin``; then
each package's descriptors end to end, their similarities against the goal
view's and the nearest neighbours that differ.  Prints max |diff|, the
largest reference magnitude and the share of values that differ.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch

    from vitvs_tpu.core import image as jimg
    from vitvs_tpu.match import correspondence as jcorr
    from vitvs_tpu.models import extractor as jext
    from vitvs_tpu.models import vit as jvit
    from vitvs_tpu.models.convert import load_params
    from vitvs_tpu_torch.core import image as timg
    from vitvs_tpu_torch.harness.pipeline import ServoModel
    from vitvs_tpu_torch.harness.rollout import goal_pose
    from vitvs_tpu_torch.io_bridge.config import VSConfig
    from vitvs_tpu_torch.models import extractor as text
    from vitvs_tpu_torch.models.convert import TRAINED_S518, from_jax_params, load_exported
    from vitvs_tpu_torch.ops import matcher as tmatch
    from vitvs_tpu_torch.sim.env import observe
    from vitvs_tpu_torch.sim.scene import load_poster_scene

    torch.set_grad_enabled(False)
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 308
    ckpt = os.path.join(REPO, "artifacts", "ckpt_real308" if size == 308 else "ckpt_real518")
    params = jax.tree.map(np.asarray, load_params(ckpt))
    sd = from_jax_params(params) if size == 308 else load_exported(TRAINED_S518)[0]
    model = ServoModel.create(VSConfig(pinv_mode="dls", dino_input_size=size), device="cpu")
    net = model.load_vit(sd)
    jcfg = jvit.make_config("dinov2_vits14")
    bf = jnp.bfloat16
    scene = load_poster_scene(device="cpu")
    p0, q0 = goal_pose("cpu")
    goal = observe(scene, model.camera, p0, q0)[0].numpy()
    frame = observe(scene, model.camera, p0 + torch.tensor([0.02, -0.01, 0.03]), q0)[0].numpy()
    f32 = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()

    def gap(name, got, ref):
        got, ref = f32(got), f32(ref)
        print(f"{name:24s} max|diff| {np.abs(got - ref).max():.4g}  max|ref| "
              f"{np.abs(ref).max():.4g}  share apart {(got != ref).mean():.4f}")

    jpp = jax.jit(lambda x: jimg.preprocess_frame(x, size))
    ref_pp = np.asarray(jpp(jnp.asarray(frame)))
    gap("preprocess", timg.preprocess_frame(torch.from_numpy(frame), size), ref_pp)
    x = torch.from_numpy(frame)
    x = timg.resize(x, (size, size), "bicubic", True)
    inv_std = torch.from_numpy(np.float32(1) / np.asarray(timg.IMAGENET_STD, np.float32))
    gap("preprocess, reciprocals", (x - torch.tensor(timg.IMAGENET_MEAN)) * inv_std, ref_pp)

    images = jnp.asarray(ref_pp)[None]
    jemb = jax.jit(lambda p, im: jvit._embed(p, jcfg, im.astype(bf), None).astype(bf))(params,
                                                                                      images)
    gap("patch embedding", net.embed(torch.from_numpy(ref_pp)[None]).to(torch.bfloat16), jemb)
    blocks = jax.tree.map(lambda a: jnp.asarray(a).astype(bf), params["blocks"])
    jblock = jax.jit(lambda x, bp: jvit._block(x, bp, jcfg, None))
    tokens = jemb
    for i in range(12):
        out = jblock(tokens, {k: v[i] for k, v in blocks.items()})
        gap(f"block {i}", net.blocks[i](torch.from_numpy(f32(tokens)).bfloat16(), False), out)
        tokens = out
    grid = model.grid()
    gap("log_bin", text.log_bin(torch.from_numpy(f32(tokens)).bfloat16()[:, 1:], grid),
        jax.jit(lambda t: jext.log_bin(t, grid))(tokens[:, 1:]))

    jdesc = jax.jit(lambda p, im: jext.extract_descriptors(p, jcfg, im, layer=11, bin=True,
                                                           compute_dtype=bf)[0, 0])

    def port_desc(rgb):
        x = timg.preprocess_frame(torch.from_numpy(rgb), size)[None]
        return text.extract_descriptors(net, x, layer=11, bin=True, use_kernels=False)[0, 0]

    jd, jg = (jdesc(params, jpp(jnp.asarray(f))[None]) for f in (frame, goal))
    td, tg = port_desc(frame), port_desc(goal)
    gap("descriptors", td, jd)
    jsim = np.asarray(jax.jit(jcorr.cosine_similarity_matrix)(jd, jg))
    tsim = (tmatch.unit_rows(td).float() @ tmatch.unit_rows(tg).float().T).numpy()
    gap("similarity", tsim, jsim)
    print(f"nearest neighbours apart: {int((jsim.argmax(1) != tsim.argmax(1)).sum())} rows + "
          f"{int((jsim.argmax(0) != tsim.argmax(0)).sum())} columns of {jsim.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
