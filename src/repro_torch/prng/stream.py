"""Chaotic-oscillator PRNG streams (port of ``repro/prng/stream.py``).

``ChaoticPRNG`` + ``StreamState`` are the chunked, resumable engine: the
oscillator state is a device tensor threaded explicitly, and every draw is
one fused-kernel launch (``ops.chaotic_bits``) that emits packed uint32
words and the next state.  Words are indexed in absolute word-row space
(the Weyl counter travels with the state), so the emitted sequence does
not depend on how draws are chunked, and ``fork()`` is counter-based.
``ChaoticStream`` is the stateful convenience wrapper over the engine.

The weight registry is read-only here: ``trained_oscillator`` reads the
committed ``results/weights/<system>.npz`` and never trains; a lattice
name (``chen@ring32``) derives its bundle from the base system's file.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
import pathlib
import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.ann import expand_lattice_params, params_from_numpy
from repro_torch.core.chaotic import (DEFAULT_LATTICE_COUPLING,
                                      parse_lattice_name)
from repro_torch.core.dse import resolve_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _splitmix_seeds(counter: int, n_streams: int, dim: int,
                    device="cpu") -> torch.Tensor:
    """Derive (S, I) float32 seeds in [-0.9, 0.9] from an integer counter.

    The hash runs in int64 masked to 32 bits; the float stage mirrors the
    JAX one op for op (uint32 -> f32, / 2**32, - 0.5, * 1.8 in f32).
    """
    idx = torch.arange(n_streams * dim, dtype=torch.int64,
                       device=device).reshape(n_streams, dim)
    z = (ops._mul32(torch.full_like(idx, int(counter) & _M32), _GOLDEN)
         + ops._mul32(idx & _M32, 0x85EBCA77)) & _M32
    z = ops._mul32(z ^ (z >> 16), 0x7FEB352D)
    z = ops._mul32(z ^ (z >> 15), 0x846CA68B)
    z = z ^ (z >> 16)
    one_point_eight = torch.tensor(1.8, dtype=torch.float32, device=device)
    return (z.to(torch.float32) / (2.0 ** 32) - 0.5) * one_point_eight


def _lineage_counter(seed: int, path: Tuple[int, ...]) -> int:
    """Fold a fork path into a 32-bit seed counter (splitmix-style chain)."""
    c = seed & 0xFFFFFFFF
    for p in path:
        c = (c ^ ((p + 1) * 0x85EBCA77)) & 0xFFFFFFFF
        c = (c ^ (c >> 16)) * 0x7FEB352D & 0xFFFFFFFF
        c = (c ^ (c >> 15)) * 0x846CA68B & 0xFFFFFFFF
        c = c ^ (c >> 16)
    return c


def effective_burn_in(burn_in: int) -> int:
    """The burn-in the engine actually runs: the fused kernel advances two
    steps per word row, so an odd request rounds up (with a warning)."""
    b = int(burn_in)
    if b < 0:
        raise ValueError(f"burn_in must be >= 0, got {burn_in}")
    if b % 2:
        warnings.warn(
            f"odd burn_in {b} rounded up to {b + 1}: the fused kernel "
            f"advances two oscillator steps per word row",
            UserWarning, stacklevel=2)
        b += 1
    return b


def _round_rows(n_rows: int, t_block: int) -> int:
    """Word rows to launch for a draw needing ``n_rows``: whole time-blocks
    for large draws, the next power of two (at least 4) for small ones.
    The overdraw is buffered, so the emitted sequence is unchanged."""
    q = max(1, t_block // 2)
    if n_rows >= q:
        return -(-n_rows // q) * q
    r = 4
    while r < n_rows:
        r *= 2
    return r


@dataclasses.dataclass
class StreamState:
    """Resumable stream cursor: everything needed to continue a stream.

    ``x`` is the oscillator state on the device; ``row`` the absolute
    word-row counter (the Weyl offset of the next row); ``buf`` the words
    already generated but not yet handed out.
    """

    x: torch.Tensor
    row: int = 0
    buf: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.uint32))
    seed: int = 0
    path: Tuple[int, ...] = ()
    burn_in: int = 0            # effective burn-in the stream was seeded with

    @property
    def n_streams(self) -> int:
        return self.x.shape[0]


class ChaoticPRNG:
    """Chunked, resumable chaotic PRNG over the fused bits kernel.

    Holds only static configuration (weights, dtype, kernel config, device);
    stream state is explicit.  ``params`` are numpy arrays or tensors.
    Given no ``config``, the kernel config is the JAX package's choice for
    ``n_streams`` lanes (``core.dse.resolve_config``).
    """

    def __init__(self, params, *, n_streams: int = 256, burn_in: int = 16,
                 activation: str = "relu", backend: str = "auto",
                 config=None, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        self.device = resolve_device(device)
        self.params = params_from_numpy(params, device=self.device)
        self.n_streams = int(n_streams)
        self.burn_in = effective_burn_in(burn_in)
        self.activation = activation
        self.backend = backend
        self.dim = self.params["w1"].shape[0]
        self.dtype = dtype
        self.config = resolve_config(config, self.params, dtype,
                                     s_total=self.n_streams)

    def init(self, seed: int = 0, path: Tuple[int, ...] = ()) -> StreamState:
        """Seed + burn in a fresh stream (rows start counting at 0 after)."""
        x = _splitmix_seeds(_lineage_counter(seed, path), self.n_streams,
                            self.dim, self.device).to(self.dtype)
        if self.burn_in:
            _, x = self._draw(x, self.burn_in // 2, 0)
        return StreamState(x=x, row=0, seed=seed, path=path,
                           burn_in=self.burn_in)

    def fork(self, state: StreamState, n_children: int) -> List[StreamState]:
        """Counter-based fork: children derive from (seed, path + (i,)),
        never from consumed parent entropy."""
        return [self.init(state.seed, state.path + (i,))
                for i in range(n_children)]

    def _draw(self, x: torch.Tensor, n_rows: int, row: int):
        """One fused launch: n_rows word rows + the advanced state."""
        return ops.chaotic_bits(self.params, x, 2 * n_rows, row,
                                activation=self.activation,
                                backend=self.backend, config=self.config)

    def next_words(self, state: StreamState, n_words: int
                   ) -> Tuple[np.ndarray, StreamState]:
        """Draw ``n_words`` uint32 words; returns (words, advanced state).

        The emitted sequence is the row-major flattening of word rows, so
        any chunking of draws yields the same sequence bit for bit.
        """
        take = min(len(state.buf), n_words)
        parts = [state.buf[:take]]
        buf = state.buf[take:]
        x, row = state.x, state.row
        need = n_words - take
        if need > 0:
            n_rows = _round_rows(-(-need // self.n_streams),
                                 self.config.t_block)
            words2d, x = self._draw(x, n_rows, row)
            flat = words2d.cpu().numpy().reshape(-1)
            parts.append(flat[:need])
            buf = flat[need:]
            row += n_rows
        return (np.concatenate(parts),
                StreamState(x=x, row=row, buf=buf, seed=state.seed,
                            path=state.path, burn_in=state.burn_in))


@dataclasses.dataclass
class ChaoticStream:
    """Stateful convenience wrapper over the resumable engine.

    Results are CPU tensors: the words reach the host in every draw.
    """

    params: Dict[str, np.ndarray]
    activation: str = "relu"
    n_streams: int = 256
    burn_in: int = 16
    backend: str = "auto"
    counter: int = 0
    device: str = "cuda"

    @classmethod
    def from_trained(cls, params, **kw) -> "ChaoticStream":
        """A stream over freshly trained weights (``core.ann
        .extract_parameters``: numpy arrays, or tensors)."""
        return cls(params={k: (v.detach().cpu().numpy()
                               if isinstance(v, torch.Tensor)
                               else np.asarray(v))
                           for k, v in params.items()}, **kw)

    @functools.cached_property
    def _engine(self) -> ChaoticPRNG:
        return ChaoticPRNG(self.params, n_streams=self.n_streams,
                           burn_in=self.burn_in, activation=self.activation,
                           backend=self.backend, device=self.device)

    @functools.cached_property
    def _state_box(self) -> List[StreamState]:
        return [self._engine.init(self.counter)]

    def _draw_words(self, n_words: int) -> np.ndarray:
        words, self._state_box[0] = self._engine.next_words(
            self._state_box[0], n_words)
        return words

    def uniform(self, shape: Tuple[int, ...],
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Uniform [0, 1): one bit more than ``dtype``'s mantissa, so no
        value rounds up to 1.0 in the final cast."""
        n = int(np.prod(shape)) if shape else 1
        nmant = round(-math.log2(torch.finfo(dtype).eps))
        m = min(24, nmant + 1)
        u = (self._draw_words(n) >> np.uint32(32 - m)).astype(np.float32) \
            * np.float32(2.0 ** -m)
        return torch.from_numpy(u.reshape(shape)).to(dtype)

    def bits(self, n_words: int) -> torch.Tensor:
        return torch.from_numpy(self._draw_words(n_words))

    def bernoulli(self, p: float, shape: Tuple[int, ...]) -> torch.Tensor:
        return self.uniform(shape) < p

    def permutation(self, n: int) -> torch.Tensor:
        """Random permutation via a stable argsort of chaotic keys."""
        return torch.from_numpy(np.argsort(self._draw_words(n), kind="stable"))

    def fork(self, n_children: int) -> List["ChaoticStream"]:
        """Counter-based fork at the wrapper level (fresh child streams)."""
        return [dataclasses.replace(
            self, counter=_lineage_counter(self.counter, (i,)))
            for i in range(n_children)]


def draw_words(w1, b1, w2, b2, counter: int, n_words: int, n_streams: int,
               burn_in: int, activation: str, backend: str,
               device="cuda") -> torch.Tensor:
    """Legacy stateless one-shot draw (kept for API compatibility).

    One trajectory launch (``ops.chaotic_trajectory``, the K2 kernel) from
    splitmix seeds, then the packing stage: a ``(n_words,)`` uint32 tensor
    on ``device``.  New code should use ``ChaoticPRNG``: it draws through
    the fused kernel and resumes instead of re-burning in on every call.
    """
    dev = resolve_device(device)
    params = params_from_numpy({"w1": w1, "b1": b1, "w2": w2, "b2": b2},
                               device=dev)
    dim = params["w1"].shape[0]
    x0 = _splitmix_seeds(int(counter) & _M32, n_streams, dim, dev)
    # 2 samples -> 1 word; streams interleave in the flattened output.
    steps_needed = 2 * ((n_words + n_streams - 1) // n_streams) + 2 * burn_in
    steps_needed = max(steps_needed, 4)
    traj = ops.chaotic_trajectory(params, x0, steps_needed,
                                  activation=activation, backend=backend)
    # Drop ALL 2*burn_in burn-in samples: dropping fewer would emit early
    # words from a half-burned-in, seed-correlated prefix.
    words = ops.pack_words(traj[2 * burn_in:])
    return words.reshape(-1)[:n_words]


# ---------------------------------------------------------------------------
# Read-only weight registry
# ---------------------------------------------------------------------------

_BUNDLE_KEYS = ("w1", "b1", "w2", "b2", "scale", "offset")
_FINGERPRINT_KEY = "recipe_fingerprint"


def weights_dir() -> pathlib.Path:
    """Disk location of the weight registry (REPRO_WEIGHTS_DIR overrides)."""
    env = os.environ.get("REPRO_WEIGHTS_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "results" / "weights"


def trained_oscillator(system: str = "chen", seed: int = 0
                       ) -> Dict[str, object]:
    """The committed weights + normalizer of a registered system.

    Reads ``<weights_dir>/<system>.npz``.  The JAX package's stamp
    (``recipe_fingerprint``, a hash over its training recipe and jax
    version) is kept as metadata under that key, not recomputed.  The port
    never trains: a missing file or another seed raises.

    A lattice name ``<base>@<ring|grid><n>`` derives its bundle from the
    base system's, as the JAX registry does: block-diagonal weights,
    ``coupling`` and ``lattice_meta`` (``core.ann.expand_lattice_params``
    at ``DEFAULT_LATTICE_COUPLING``), ``scale``/``offset`` tiled per node.
    It is never written to disk.
    """
    if "@" in system:
        base_name, topology, n_nodes = parse_lattice_name(system)
        base = trained_oscillator(base_name, seed)
        return dict(
            expand_lattice_params(base, n_nodes=n_nodes,
                                  coupling=DEFAULT_LATTICE_COUPLING,
                                  topology=topology),
            scale=np.tile(base["scale"], n_nodes),
            offset=np.tile(base["offset"], n_nodes))
    if seed != 0:
        raise ValueError(f"only seed 0 is committed to the registry, got "
                         f"{seed}; the port does not train")
    path = weights_dir() / f"{system}.npz"
    if not path.exists():
        raise FileNotFoundError(f"no committed weights for {system!r} at "
                                f"{path}; the port does not train")
    with np.load(path) as npz:
        bundle: Dict[str, object] = {k: np.asarray(npz[k]) for k in npz.files}
    missing = set(_BUNDLE_KEYS) - set(bundle)
    if missing:
        raise ValueError(f"{path} lacks {sorted(missing)}")
    if _FINGERPRINT_KEY in bundle:
        bundle[_FINGERPRINT_KEY] = str(bundle[_FINGERPRINT_KEY])
    return bundle


def default_params(seed: int = 0, system: str = "chen"
                   ) -> Dict[str, np.ndarray]:
    """The oscillator weights ``w1, b1, w2, b2`` of a registered system,
    with ``coupling`` and ``lattice_meta`` for a lattice."""
    bundle = trained_oscillator(system, seed)
    keys = ("w1", "b1", "w2", "b2", "coupling", "lattice_meta")
    return {k: bundle[k] for k in keys if k in bundle}


def default_stream(n_streams: int = 256, seed: int = 0,
                   system: str = "chen", device="cuda") -> ChaoticStream:
    """A ready-to-use stream over a registry oscillator (Chen by default)."""
    return ChaoticStream.from_trained(default_params(seed, system),
                                      n_streams=n_streams, device=device)
