"""Chunk and checkpoint machinery of the benchmark
(``vitvs_tpu/harness/chunks.py``): the last chunk padded to the chunk's
width, per-chunk perturbed textures from generators seeded by the ABSOLUTE
episode index, the fingerprinted atomic episode checkpoint after every
chunk, and the frozen tail that stands in for the steps of a chunk whose
episodes are all done."""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from vitvs_tpu_torch.sim.perturb import perturb_texture


def pad_tail(a: np.ndarray, pad: int) -> np.ndarray:
    """Pad a chunk to its width by repeating its last row (the last episode,
    whose generators are then seeded alike: the padding repeats it)."""
    if pad:
        a = np.concatenate([a, np.repeat(a[-1:], pad, 0)])
    return a


def make_textures_for(perturb_seed: int, texture: torch.Tensor):
    """Per-chunk perturbed-texture factory: ``textures_for(abs_ids)`` gives
    one texture per absolute episode index, drawn on the texture's device
    from a generator seeded ``(perturb_seed << 32) + index`` (so chunk-,
    resume- and replay-invariant).  Generated per chunk, never for the whole sweep: 500
    copies of the 1500x1125 poster are about 10 GB."""

    def textures_for(abs_ids) -> list[torch.Tensor]:
        out = []
        for i in abs_ids:
            gen = torch.Generator(device=texture.device)
            gen.manual_seed((int(perturb_seed) << 32) + int(i))
            out.append(perturb_texture(gen, texture))
        return out

    return textures_for


def load_episodes(checkpoint_path: str | None, tag: str = "bench", verbose: bool = True,
                  meta: dict | None = None) -> tuple[list, dict]:
    """Resume the completed-episode list (whole chunks, so the benchmark's
    ``range(len(episodes), n, chunk)`` lands on a chunk boundary).

    ``meta`` is the caller's run fingerprint (episode indices, config,
    flags...): a checkpoint written by a run with another fingerprint
    refuses to resume.  Only a file this program wrote may be passed
    (it is unpickled).  Returns (episodes, extra), ``extra`` being the
    benchmark's resumable state (the rotation search's results)."""
    if checkpoint_path and os.path.exists(checkpoint_path):
        with open(checkpoint_path, "rb") as fh:
            payload = pickle.load(fh)
        episodes = payload["episodes"]
        saved_meta = payload.get("meta")
        if meta is not None and saved_meta != meta:
            diff = sorted(k for k in set(saved_meta or {}) | set(meta)
                          if (saved_meta or {}).get(k) != meta.get(k))
            raise ValueError(
                f"[{tag}] resume checkpoint {checkpoint_path} was written by a different "
                f"run (mismatched: {diff}); delete it or pass another checkpoint path")
        if verbose:
            print(f"[{tag}] resumed {len(episodes)} episodes from {checkpoint_path}")
        return episodes, payload.get("extra") or {}
    return [], {}


def save_episodes(checkpoint_path: str | None, episodes: list, meta: dict | None = None,
                  extra: dict | None = None) -> None:
    """Atomic (tmp + rename) checkpoint write, fingerprinted with ``meta``."""
    if not checkpoint_path:
        return
    tmp = checkpoint_path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump({"meta": meta, "episodes": episodes, "extra": extra or {}}, fh)
    os.replace(tmp, checkpoint_path)


def frozen_tail(ys: dict, rest: int) -> dict:
    """The histories (B, rest, ...) of ``rest`` more steps of a chunk whose
    episodes are all frozen (done or aborted) at the end of ``ys`` (B, n,
    ...): the rollout would re-record the frozen poses and errors with zero
    commands, so they are built here instead of run on the device;
    bit-identical."""
    tile = lambda x: x[:, -1:].expand((x.shape[0], rest) + x.shape[2:])  # noqa: E731
    v_c = ys["v_c"]
    zeros = torch.zeros((v_c.shape[0], rest, 6), dtype=v_c.dtype, device=v_c.device)
    return {"position": tile(ys["position"]), "quat": tile(ys["quat"]), "v_c": zeros,
            "twist": zeros, "err": tile(ys["err"]),
            "active": torch.zeros((v_c.shape[0], rest), dtype=torch.bool,
                                  device=ys["active"].device)}
