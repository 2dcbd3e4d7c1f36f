#!/usr/bin/env python3
"""The training step of the PyTorch port against the JAX package's, on the
same batches: both start from the same JAX-initialized weights, take the
same servo pair batches (drawn by the port's sampler on the CPU, on the real
poster or the synthetic one) and the same warm-up cosine AdamW schedule,
and print the mean loss of each window of 25 steps and block 0's mean
|LayerScale| in both.

    python scripts/port_train_dynamics.py [--depth 4] [--size 112] [--steps 300]
        [--batch 4] [--dtype bfloat16] [--poster real|synthetic]

Runs on the CPU where JAX, optax and the port are installed.  It shows
whether the two training steps drift apart over many updates, which the
one-step parity tests (tests/test_torch_train.py) cannot show.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--size", type=int, default=112)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--poster", default="real", choices=["real", "synthetic"])
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    import torch

    from vitvs_tpu.harness.pipeline import ServoModel as JModel
    from vitvs_tpu.io_bridge.config import VSConfig as JCfg
    from vitvs_tpu.models import vit as jvit
    from vitvs_tpu.train import finetune as jft
    from vitvs_tpu_torch.harness.pipeline import ServoModel
    from vitvs_tpu_torch.io_bridge.config import VSConfig
    from vitvs_tpu_torch.models import vit as tvit
    from vitvs_tpu_torch.models.convert import from_jax_params
    from vitvs_tpu_torch.train import finetune as tft
    from vitvs_tpu_torch.train.train_servo import scene_of

    torch.set_num_threads(args.threads)
    kw = dict(patch_size=14, embed_dim=384, depth=args.depth, num_heads=6, pos_grid=37,
              model_name="dinov2_vits14", gelu_approx=True)
    cfg = dict(dino_input_size=args.size, layer=args.depth - 1)
    jm = JModel(vit=jvit.ViTConfig(**kw), cfg=JCfg(**cfg), compute_dtype=getattr(jnp, args.dtype))
    tm = ServoModel(vit=tvit.ViTConfig(**kw), cfg=VSConfig(**cfg),
                    compute_dtype=getattr(torch, args.dtype), device="cpu")
    params = jvit.init_vit(jm.vit, jax.random.PRNGKey(0))
    net = tvit.ViT(tm.vit)
    net.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    lr, warmup, decay = 3e-4, 100, 3000
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay, lr * 0.05),
                      weight_decay=1e-4)
    ostate = opt.init(params)

    @jax.jit
    def jax_step(p, s, goal, batch):
        loss, g = jax.value_and_grad(lambda p: jft._servo_batch_loss(p, jm, goal, batch))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    state = tft.init_train_state(
        net, tft.warmup_cosine_decay_schedule(0.0, lr, warmup, decay, lr * 0.05))
    scene = scene_of(None if args.poster == "real" else args.poster, "cpu")
    gen = torch.Generator().manual_seed(1)
    jl, tl = [], []
    t0 = time.time()
    print(f"depth {args.depth}, {args.size} px, batch {args.batch}, {args.dtype}, "
          f"{args.poster} poster", flush=True)
    for i in range(args.steps):
        goal, data = tft.make_servo_pair_batch(tm, scene, gen, args.batch)
        params, ostate, loss = jax_step(params, ostate, jnp.asarray(goal.numpy()),
                                        {k: jnp.asarray(v.numpy()) for k, v in data.items()})
        jl.append(float(loss))
        loss = tft._servo_batch_loss(state.net, tm, goal, data)
        state = tft.apply_gradients(state, loss)
        tl.append(loss.item())
        if (i + 1) % 25 == 0:
            ls_j = float(jnp.abs(params["blocks"]["ls1"][0]).mean())
            ls_t = float(state.net.blocks[0].ls1.gamma.detach().abs().mean())
            print(f"steps {i - 23}-{i + 1}: jax {np.mean(jl[-25:]):.4f} port "
                  f"{np.mean(tl[-25:]):.4f}; block 0 |ls1| jax {ls_j:.3e} port {ls_t:.3e} "
                  f"[{time.time() - t0:.0f} s]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
