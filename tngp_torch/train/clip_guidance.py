"""CLIP text-image guidance for GT-free training — the port of
`tngp/train/clip_guidance.py`.

Every `rand_pose`-th step the trainer renders a random orbit pose and
minimises the negative cosine similarity between the image embedding of the
render and the text embedding (`Trainer.run_clip_step`; torch-ngp's
nerf/clip_utils.py:11-64 and nerf/utils.py:431-434, 485-499).  The image
tower has to be differentiable, so it runs in torch on the render's device.
Two embedders:

  * `TorchCLIPEmbedder` — transformers' `CLIPModel` from a local snapshot
    (nothing is downloaded; without a snapshot, or without `transformers`,
    it raises an error that names `--clip_model_path`);
  * `StubEmbedder` — a deterministic random-feature embedder for tests and
    as an explicit opt-in (`--clip_model_path stub`), which exercises the
    same training plumbing.

`CLIPLoss` is the non-differentiable scorer kept for eval-time similarity
reports, as the JAX package keeps it.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch
import torch.nn.functional as F

# CLIP pixel normalization constants (clip_utils.py:30-31)
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _resize_normalize(images: torch.Tensor, r: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, r, r, 3]: bilinear (antialiased when it shrinks,
    as `jax.image.resize(..., "bilinear")`), then CLIP's normalization."""
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(r, r), mode="bilinear",
                      antialias=True, align_corners=False).permute(0, 2, 3, 1)
    mean = torch.tensor(_CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(_CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def _l2_normalize(feats: torch.Tensor) -> torch.Tensor:
    return feats / (torch.linalg.norm(feats, dim=-1, keepdim=True) + 1e-8)


class StubEmbedder:
    """Deterministic differentiable stand-in for CLIP (tests, no weights).

    Image tower: resize to 32x32, normalize, project the flattened pixels
    with a fixed random matrix [3072, 64] / sqrt(3072), l2-normalize.  Text
    tower: a seeded random unit vector from the sha256 of the text, the JAX
    package's numpy code.  `projection` takes the matrix (the tests pass
    the JAX stub's `jax.random.normal(PRNGKey(0))`); by default it is the
    port's own, from torch's generator seeded 0: the stub carries no
    meaning, so the two packages' default stubs differ."""

    embed_dim = 64
    resolution = 32

    def __init__(self, projection=None, device="cuda"):
        n = self.resolution * self.resolution * 3
        if projection is None:
            gen = torch.Generator().manual_seed(0)
            projection = torch.randn((n, self.embed_dim), generator=gen) / np.sqrt(n)
        if not torch.is_tensor(projection):
            projection = np.array(projection, np.float32)
        self.projection = torch.as_tensor(projection, dtype=torch.float32, device=device)
        if tuple(self.projection.shape) != (n, self.embed_dim):
            raise ValueError(f"projection: expected shape {(n, self.embed_dim)}, got "
                             f"{tuple(self.projection.shape)}")

    def embed_images(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0,1] -> [B, D] l2-normalized (differentiable)."""
        x = _resize_normalize(images, self.resolution)
        return _l2_normalize(x.reshape(x.shape[0], -1) @ self.projection.to(x.device))

    def embed_text(self, text: str) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:4], "little")
        v = np.random.default_rng(seed).normal(size=(self.embed_dim,)).astype(np.float32)
        return v / (np.linalg.norm(v) + 1e-8)


def _snapshot_error(model_path: str, e: Exception, flag: str = "--clip_model_path"):
    return RuntimeError(
        "CLIP guidance needs a local snapshot of a CLIP checkpoint "
        f"(tried '{model_path}'): {e}. Point {flag} at a local HuggingFace CLIP "
        "directory, or use the stub embedder (--clip_model_path stub).")


class TorchCLIPEmbedder:
    """Differentiable CLIP towers through transformers' `CLIPModel`, from a
    local snapshot only (the counterpart of the JAX package's
    `FlaxCLIPEmbedder`); raises naming `--clip_model_path` otherwise."""

    def __init__(self, model_path: str = "openai/clip-vit-base-patch16", device="cuda"):
        try:
            if not os.path.isdir(model_path):  # before the slow import
                raise FileNotFoundError(f"no directory '{model_path}'")
            from transformers import AutoTokenizer, CLIPModel

            self.model = CLIPModel.from_pretrained(model_path, local_files_only=True).to(device)
            self.tokenizer = AutoTokenizer.from_pretrained(model_path, local_files_only=True)
        except Exception as e:
            raise _snapshot_error(model_path, e) from e
        self.model.requires_grad_(False)
        self.device = device
        self.embed_dim = int(self.model.config.projection_dim)
        self.resolution = int(self.model.config.vision_config.image_size)

    def embed_images(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0,1] -> [B, D] l2-normalized (differentiable)."""
        x = _resize_normalize(images, self.resolution).permute(0, 3, 1, 2)  # NCHW
        return _l2_normalize(self.model.get_image_features(pixel_values=x))

    @torch.no_grad()
    def embed_text(self, text: str) -> np.ndarray:
        inputs = self.tokenizer([text], return_tensors="pt", padding=True).to(self.device)
        feats = self.model.get_text_features(**inputs)[0].float().cpu().numpy()
        return feats / (np.linalg.norm(feats) + 1e-8)


def make_embedder(kind: str = "auto", model_path: str = "openai/clip-vit-base-patch16",
                  device="cuda"):
    """'stub' -> `StubEmbedder`; anything else ('torch', 'auto') ->
    `TorchCLIPEmbedder` from the local snapshot at `model_path`."""
    if kind == "stub":
        return StubEmbedder(device=device)
    return TorchCLIPEmbedder(model_path, device=device)


class CLIPLoss:
    """Non-differentiable CLIP similarity scorer (nerf/clip_utils.py:11-64),
    from a local snapshot only."""

    def __init__(self, model_path: str = "openai/clip-vit-base-patch16"):
        try:
            if not os.path.isdir(model_path):
                raise FileNotFoundError(f"no directory '{model_path}'")
            from transformers import CLIPModel, CLIPProcessor

            self.model = CLIPModel.from_pretrained(model_path, local_files_only=True)
            self.processor = CLIPProcessor.from_pretrained(model_path, local_files_only=True)
        except Exception as e:
            raise _snapshot_error(model_path, e, "model_path") from e
        self.text_features = None

    def prepare_text(self, texts):
        inputs = self.processor(text=texts, return_tensors="pt", padding=True)
        with torch.no_grad():
            feats = self.model.get_text_features(**inputs)
        self.text_features = feats / feats.norm(dim=-1, keepdim=True)

    def __call__(self, images_np):
        """images_np: [B, H, W, 3] float in [0,1] -> negative mean cosine sim."""
        if self.text_features is None:
            raise RuntimeError("call prepare_text first")
        x = torch.from_numpy(np.asarray(images_np)).permute(0, 3, 1, 2).float()
        x = F.interpolate(x, (224, 224), mode="bilinear")
        mean = torch.tensor(_CLIP_MEAN).view(1, 3, 1, 1)
        std = torch.tensor(_CLIP_STD).view(1, 3, 1, 1)
        with torch.no_grad():
            feats = self.model.get_image_features(pixel_values=(x - mean) / std)
        feats = feats / feats.norm(dim=-1, keepdim=True)
        return -float((feats @ self.text_features.T).mean())
