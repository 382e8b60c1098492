"""Vector quantizer (counterpart of `ealdm_tpu/models/quantize.py`): the
nearest-code lookup with the straight-through gradient and the
beta-weighted commitment loss of VQ-GAN training."""
from __future__ import annotations

import torch
from torch import nn


class VectorQuantizer(nn.Module):
    """Codebook of `n_embed` x `embed_dim`; input NHWC with C == embed_dim."""

    def __init__(self, n_embed: int, embed_dim: int, beta: float = 0.25):
        super().__init__()
        self.n_embed, self.embed_dim, self.beta = n_embed, embed_dim, beta
        self.embedding = nn.Parameter(torch.zeros(n_embed, embed_dim))

    def forward(self, z):
        """(z_q, codebook_loss, (perplexity, None, indices)): nearest code by
        fp32 ||z||^2 - 2 z.e + ||e||^2, the first index on ties. The loss is
        beta * |sg(z_q) - z|^2 (the commitment, into the encoder) plus
        |z_q - sg(z)|^2 (into the codebook), and z_q passes the decoder's
        gradient straight through to z, as JAX's `stop_gradient`s do."""
        b, h, w, c = z.shape
        if c != self.embed_dim:
            raise ValueError(f"expected {self.embed_dim} channels, got {c}")
        flat = z.reshape(-1, c).float()
        codebook = self.embedding.float()
        dist = (
            flat.square().sum(1, keepdim=True)
            - 2.0 * flat @ codebook.T
            + codebook.square().sum(1)[None, :]
        )
        indices = torch.argmin(dist, dim=1)
        z_q = codebook[indices].reshape(b, h, w, c).to(z.dtype)
        loss = (self.beta * torch.mean(torch.square(z_q.detach() - z))
                + torch.mean(torch.square(z_q - z.detach())))
        z_q = z + (z_q - z).detach()  # straight-through
        counts = torch.bincount(indices, minlength=self.n_embed).float()
        p = counts / indices.numel()
        perplexity = torch.exp(-torch.sum(p * torch.log(p + 1e-10)))
        return z_q, loss, (perplexity, None, indices.reshape(b, h, w))

    def embed_code(self, indices):
        """Integer codes [...] -> embeddings [..., embed_dim]."""
        return self.embedding[indices]
