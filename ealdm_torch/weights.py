"""Pretrained weights of the evaluation trunks from files on disk
(counterpart of `ealdm_tpu/weights.py`).

Point ``EALDM_WEIGHTS_DIR`` at a directory that holds any of the canonical
checkpoints below, and the trunks load them when they are built: the FID
InceptionV3 and the CLIP scorer of the third stage, and LPIPS in the
first-stage trainer. Nothing is downloaded.

Canonical file names of each trunk, searched in this order (the first one
present wins):

* ``inception``: ``pt_inception-2015-12-05.pth``, ``inception.pth``,
  ``inception.pt``, ``inception.npz`` (torchvision ``inception_v3`` naming,
  as torchmetrics' FrechetInceptionDistance uses);
* ``clip``: ``ViT-B-32.pt``, ``clip_vit_b32.pt``, ``clip.pth``, ``clip.pt``,
  ``clip.npz`` (OpenAI ``clip`` or Hugging Face ``CLIPModel`` naming; the
  TorchScript archives of ``clip.load`` are read too);
* ``lpips``: ``vgg_lpips.pth``, ``vgg.pth``, ``lpips.pth``, ``lpips.npz``
  (taming's ``vgg_lpips`` or a raw torchvision VGG16).

``load_state_dict_file`` decodes any of them: ``.npz`` archives with numpy,
the rest with ``torch.load(weights_only=True)`` (plain or Lightning-wrapped
state dicts) and then ``torch.jit.load`` for TorchScript archives. It never
unpickles with ``weights_only=False``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

ENV_VAR = "EALDM_WEIGHTS_DIR"

CANONICAL_FILES: Dict[str, tuple] = {
    "inception": ("pt_inception-2015-12-05.pth", "inception.pth", "inception.pt",
                  "inception.npz"),
    "clip": ("ViT-B-32.pt", "clip_vit_b32.pt", "clip.pth", "clip.pt", "clip.npz"),
    "lpips": ("vgg_lpips.pth", "vgg.pth", "lpips.pth", "lpips.npz"),
}


def weights_dir() -> Optional[str]:
    """$EALDM_WEIGHTS_DIR, or None when it is unset. A value that is not a
    directory (a typo in a deployment, most likely) warns and gives None, so
    the trunks keep their seeded weights."""
    d = os.environ.get(ENV_VAR)
    if not d:
        return None
    if not os.path.isdir(d):
        import warnings

        warnings.warn(f"{ENV_VAR}={d!r} is not a directory; eval-trunk weights will NOT be "
                      "loaded (FID/CLIP/LPIPS run random-init)", stacklevel=2)
        return None
    return d


def find_weights(kind: str, directory: Optional[str] = None) -> Optional[str]:
    """The path of the first canonical `kind` checkpoint in `directory`
    (default $EALDM_WEIGHTS_DIR), or None."""
    d = directory or weights_dir()
    if d is None:
        return None
    for name in CANONICAL_FILES[kind]:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


def load_state_dict_file(path: str) -> Dict:
    """A checkpoint file as a flat {name: array or tensor} state dict."""
    if path.endswith(".npz"):
        import numpy as np

        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as pickle_err:
        try:
            obj = torch.jit.load(path, map_location="cpu")
        except Exception as jit_err:
            raise ValueError(
                f"{path}: not decodable as a weights-only pickle ({pickle_err}) nor as a "
                f"TorchScript archive ({jit_err}). If this is a full-object torch checkpoint, "
                "re-save it as a plain state_dict; weights_only=False loading is not "
                "supported (arbitrary code execution risk).") from jit_err
    if hasattr(obj, "state_dict") and not isinstance(obj, dict):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj and not any(
            hasattr(v, "shape") for v in obj.values() if not isinstance(v, dict)):
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: decoded to {type(obj)!r}, not a state_dict")
    return obj


def load_lpips_params(lpips, path: Optional[str] = None):
    """`lpips` (a `losses.LPIPS`) with the VGG and head weights of `path`
    (default: the canonical checkpoint in $EALDM_WEIGHTS_DIR) copied in, in
    place; unchanged when there is no checkpoint. Returns `lpips`."""
    p = path or find_weights("lpips")
    if p is None:
        return lpips
    from .losses.lpips import load_torch_lpips_weights

    return load_torch_lpips_weights(lpips, load_state_dict_file(p))
