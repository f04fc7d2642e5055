"""Bot-score head: request features from a staged batch, scored by a
small logistic MLP (the JAX package's `models/botscore.py`).

`extract_features` reads the tensors of a staged batch (the arrays the
verdict reads, on the same device) and gives [B, 46] float32: field
lengths, the user agent's byte-class composition, the path's shape,
and hash buckets of method, country, ASN and port. `score` runs the
two-layer MLP over them. The head is plain PyTorch: the JAX package
computes it with `jnp` ops under `jax.jit`, outside any Pallas kernel,
so it has no hand-written kernel here either.

Weights carry across as numpy arrays (`params_from_reference`), and
the npz files of `save_params`/`load_params` are the JAX package's
format, so weights trained by either package load in the other.
`make_train_step` uses `torch.optim.AdamW` with optax.adamw's defaults.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

NUM_FEATURES = 46
HIDDEN = 64

# The arrays of a staged batch that the features read.
INPUT_KEYS = ("user_agent_bytes", "user_agent_len", "path_bytes", "path_len",
              "url_len", "host_len", "method_bytes", "method_len",
              "country_bytes", "asn", "remote_port")

# Knuth's multiplicative hash constant, split in 16-bit halves so the
# wrapping uint32 product never leaves int64.
_ASN_MUL_LO = 2654435761 & 0xFFFF
_ASN_MUL_HI = 2654435761 >> 16


def _asn_bucket(asn: torch.Tensor) -> torch.Tensor:
    """((uint32(asn) * 2654435761) mod 2^32) >> 24, mod 8."""
    a = asn.to(torch.int64) & 0xFFFFFFFF
    h = (a * _ASN_MUL_LO + (((a * _ASN_MUL_HI) & 0xFFFF) << 16)) \
        & 0xFFFFFFFF
    return (h >> 24) % 8


def extract_features(arrays: dict) -> torch.Tensor:
    """The tensors of a staged batch -> [B, NUM_FEATURES] float32 on
    their device. A byte count covers only the columns staged: under
    compact staging a length may pass its field's width, and the
    fractions then divide a capped count by the true length, as in the
    JAX package."""
    f32 = torch.float32

    def norm_len(key: str, cap: float) -> torch.Tensor:
        return (arrays[f"{key}_len"].to(f32) / cap)[:, None]

    def live(data: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        cols = torch.arange(data.shape[1], dtype=torch.int32,
                            device=data.device)
        return cols[None, :] < lens.to(torch.int32)[:, None]

    ua = arrays["user_agent_bytes"]
    ua_ok = live(ua, arrays["user_agent_len"])
    ua_len = torch.clamp_min(arrays["user_agent_len"].to(f32), 1.0)

    def frac(lo: int, hi: int) -> torch.Tensor:
        inside = (ua >= lo) & (ua <= hi) & ua_ok
        return (inside.sum(dim=1).to(f32) / ua_len)[:, None]

    path = arrays["path_bytes"]
    path_ok = live(path, arrays["path_len"])

    def count(byte: int) -> torch.Tensor:
        return ((path == byte) & path_ok).sum(dim=1).to(f32)[:, None]

    method = arrays["method_bytes"].to(torch.int64)
    method_hash = (method[:, 0] * 7 + arrays["method_len"].to(torch.int64)) % 8
    country = arrays["country_bytes"].to(torch.int64)
    country_hash = (country[:, 0] * 31 + country[:, 1]) % 16
    port = arrays["remote_port"].to(f32) / 65535.0

    def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
        classes = torch.arange(n, dtype=idx.dtype, device=idx.device)
        return (idx[:, None] == classes[None, :]).to(f32)

    feats = torch.cat([
        norm_len("user_agent", 256.0),
        norm_len("path", 256.0),
        norm_len("url", 512.0),
        norm_len("host", 128.0),
        (arrays["user_agent_len"] == 0).to(f32)[:, None],
        frac(0x30, 0x39),  # digits
        frac(0x41, 0x5A),  # uppercase
        frac(0x61, 0x7A),  # lowercase
        frac(0x20, 0x2F),  # punctuation-ish
        count(0x2F) / 32.0,  # slashes
        count(0x2E) / 16.0,  # dots
        count(0x25) / 16.0,  # percent signs
        port[:, None],
        one_hot(method_hash, 8),
        one_hot(country_hash, 16),
        one_hot(_asn_bucket(arrays["asn"]), 8),
        torch.ones((ua.shape[0], 1), dtype=f32, device=ua.device),  # bias
    ], dim=1)
    assert feats.shape[1] == NUM_FEATURES, feats.shape
    return feats


class Params(NamedTuple):
    w1: torch.Tensor  # [F, H]
    b1: torch.Tensor  # [H]
    w2: torch.Tensor  # [H, 1]
    b2: torch.Tensor  # [1]

    def to(self, device) -> "Params":
        return Params(*(t.to(device) for t in self))


def init_params(generator: torch.Generator, hidden: int = HIDDEN,
                device=None) -> Params:
    """Seeded weights (normal, scaled by 1/sqrt(fan-in); zero biases),
    drawn on the CPU from `generator` and placed on `device`."""
    dev = resolve_device(device)
    scale1 = 1.0 / np.sqrt(NUM_FEATURES)
    scale2 = 1.0 / np.sqrt(hidden)
    w1 = torch.randn((NUM_FEATURES, hidden), generator=generator) * scale1
    w2 = torch.randn((hidden, 1), generator=generator) * scale2
    return Params(w1=w1, b1=torch.zeros(hidden), w2=w2,
                  b2=torch.zeros(1)).to(dev)


def params_from_reference(w1, b1, w2, b2, device=None) -> Params:
    """Numpy arrays (the JAX package's Params, through np.asarray) ->
    the port's Params on `device`, each in its own dtype: the JAX
    package, which enables 64-bit types, draws float64 weights beside
    float32 biases."""
    dev = resolve_device(device)
    return Params(*(torch.from_numpy(np.array(a))
                    for a in (w1, b1, w2, b2))).to(dev)


def logits(params: Params, feats: torch.Tensor) -> torch.Tensor:
    """The MLP in the widest dtype of the features and weights, as the
    JAX package's type promotion computes it."""
    dt = feats.dtype
    for t in params:
        dt = torch.promote_types(dt, t.dtype)
    w1, b1, w2, b2 = (t.to(dt) for t in params)
    h = torch.relu(feats.to(dt) @ w1 + b1)
    return (h @ w2 + b2)[:, 0]


def score(params: Params, arrays: dict) -> torch.Tensor:
    """[B] bot probability in [0, 1] on the batch's device."""
    return torch.sigmoid(logits(params, extract_features(arrays)))


def bce_loss(params: Params, feats: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    lg = logits(params, feats)
    labels = labels.to(lg.dtype)
    return torch.mean(torch.clamp_min(lg, 0) - lg * labels
                      + torch.log1p(torch.exp(-torch.abs(lg))))


def save_params(params: Params, path: str) -> None:
    """Persist weights (npz, the JAX package's format) for the server's
    --bot-score-params."""
    np.savez(path, **{name: t.detach().cpu().numpy()
                      for name, t in params._asdict().items()})


def load_params(path: str, device=None) -> Params:
    with np.load(path) as data:
        return params_from_reference(data["w1"], data["b1"], data["w2"],
                                     data["b2"], device=device)


class AdamW:
    """optax.adamw's defaults on `torch.optim.AdamW`: betas (0.9, 0.999),
    eps 1e-8, weight decay 1e-4 (torch's own default is 1e-2)."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params: Params) -> torch.optim.AdamW:
        # Each leaf keeps its dtype, as optax's state does.
        leaves = [p.detach().clone().requires_grad_(True) for p in params]
        return torch.optim.AdamW(leaves, lr=self.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)


def make_train_step(learning_rate: float = 1e-3):
    """(tx, train_step), as in the JAX package: `tx.init(params)` gives
    the optimizer state, and train_step(params, opt_state, feats,
    labels) -> (params, opt_state, loss) takes one AdamW step on the
    BCE loss."""
    tx = AdamW(learning_rate)

    def train_step(params: Params, opt_state: torch.optim.AdamW, feats,
                   labels):
        leaves = opt_state.param_groups[0]["params"]
        with torch.no_grad():
            for leaf, p in zip(leaves, params):
                leaf.copy_(p)
        opt_state.zero_grad()
        loss = bce_loss(Params(*leaves), feats, labels)
        loss.backward()
        opt_state.step()
        return (Params(*(leaf.detach().clone() for leaf in leaves)),
                opt_state, loss.detach())

    return tx, train_step
