"""Data pipeline: a deterministic synthetic LM token stream with a chaotic
PRNG shuffle (port of ``repro/data/pipeline.py``).

The numpy batches are the JAX pipeline's, bit for bit.  With
``use_chaotic_shuffle`` each batch's rows are permuted by the port's
``default_stream`` (the registry chen oscillator, 256 lanes, on
``device``): its draws launch the fused kernel K1 on the card.  As in the
reference, the stream advances with every ``batch_at`` call, so under the
shuffle a batch is not a pure function of (seed, step): a resumed run
sees other permutations than an uninterrupted one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class SyntheticLMDataset:
    """Markov-chain token stream — enough structure that loss decreases."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    use_chaotic_shuffle: bool = False
    n_docs: int = 512
    device: str = "cuda"

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse bigram transition table: each token has 8 likely successors
        self.successors = rng.integers(
            0, self.vocab_size, size=(self.vocab_size, 8), dtype=np.int32)
        if self.use_chaotic_shuffle:
            from repro_torch.prng import default_stream
            self._stream = default_stream(n_streams=256, seed=self.seed,
                                          device=self.device)
        else:
            self._stream = None

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.global_batch, self.seq_len
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=b)
        choice = rng.integers(0, 8, size=(b, s))
        mix = rng.random((b, s)) < 0.1    # 10% noise tokens
        noise = rng.integers(0, self.vocab_size, size=(b, s), dtype=np.int32)
        for t in range(s):
            nxt = self.successors[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(mix[:, t], noise[:, t], nxt)
        if self._stream is not None:
            perm = self._stream.permutation(b).numpy()
            toks = toks[perm]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def make_dataset(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 chaotic_shuffle: bool = False,
                 device: str = "cuda") -> SyntheticLMDataset:
    return SyntheticLMDataset(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=seed,
        use_chaotic_shuffle=chaotic_shuffle, device=device)
