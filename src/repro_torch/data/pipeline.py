"""Data pipeline: deterministic synthetic LM corpus + document packing
(counterpart: ``repro/data/pipeline.py``, a copy: pure numpy, so every
batch is byte-identical to the reference's for the same seed and step; the
unigram draw takes ``rng.choice``'s cdf once instead of once a position,
the same numbers from the same generator state).

Determinism contract (fault-tolerance substrate): batch(step) is a pure
function of (seed, step, global shape) — a restarted job resumes the exact
token stream from the checkpointed step. Batches are numpy arrays on the
host; the train loop moves them to the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.specs import input_specs


@dataclass
class SyntheticLMDataset:
    """Zipf-unigram + order-1 Markov synthetic language.

    Has learnable structure (bigram transitions) so example training runs
    show honest loss decrease below the unigram entropy floor.
    """

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.vocab_size
        # zipf unigram over vocab
        ranks = np.arange(1, V + 1)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # rng.choice(V, p=unigram)'s own cdf, computed once: a draw is
        # cdf.searchsorted(rng.random(B), side="right"), the same numbers
        # from the same generator state without an O(V) pass a position
        self._cdf = self.unigram.cumsum()
        self._cdf /= self._cdf[-1]
        # low-rank markov structure: state -> preferred token band
        self.state_of = rng.integers(0, self.n_states, size=V)
        self.next_state = rng.permutation(self.n_states)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        toks = np.empty((B, S), np.int32)
        cur = rng.integers(0, self.n_states, size=B)
        band = max(V // self.n_states, 1)
        for t in range(S):
            # with p=0.75 sample from the state's token band, else unigram
            use_band = rng.random(B) < 0.75
            band_tok = (cur * band + rng.integers(0, band, size=B)) % V
            uni_tok = self._cdf.searchsorted(rng.random(B), side="right")
            toks[:, t] = np.where(use_band, band_tok, uni_tok)
            cur = self.next_state[self.state_of[toks[:, t]]]
        return {"tokens": toks, "labels": toks.copy()}


def pack_documents(docs: list, seq_len: int, eos: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack variable-length documents into fixed rows; returns (tokens, mask).

    mask=0 at positions crossing a document boundary (no cross-doc loss).
    """
    rows, masks = [], []
    buf: list = []
    mbuf: list = []
    for doc in docs:
        for i, tok in enumerate(list(doc) + [eos]):
            buf.append(tok)
            mbuf.append(0 if i == len(doc) else 1)
            if len(buf) == seq_len:
                rows.append(buf)
                masks.append(mbuf)
                buf, mbuf = [], []
    if buf:
        pad = seq_len - len(buf)
        rows.append(buf + [eos] * pad)
        masks.append(mbuf + [0] * pad)
    return np.asarray(rows, np.int32), np.asarray(masks, np.float32)


def make_batch_fn(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0):
    """Returns batch(step) -> dict of numpy arrays matching input_specs."""
    ds = SyntheticLMDataset(cfg.vocab_size, shape.seq_len, shape.global_batch,
                            seed)
    spec = input_specs(cfg, shape.replace(mode="train"))

    def fn(step: int) -> Dict[str, np.ndarray]:
        b = ds.batch(step)
        rng = np.random.default_rng(seed + 7 * step + 13)
        if "patch_embeds" in spec:
            n = spec["tokens"].shape[1]
            b["tokens"] = b["tokens"][:, :n]
            b["labels"] = b["labels"][:, :n]
            b["patch_embeds"] = rng.standard_normal(
                spec["patch_embeds"].shape).astype(np.float32)
        if cfg.family == "audio":
            src = int(shape.seq_len * cfg.src_len_ratio)
            b["src_embeds"] = rng.standard_normal(
                (shape.global_batch, src, cfg.d_model)).astype(np.float32)
        return b

    return fn
