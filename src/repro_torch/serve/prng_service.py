"""Streaming chaotic-PRNG serving engine (port of
``repro/serve/prng_service.py``, single device).

Many named client streams are served from one kernel launch: each client
owns a contiguous block of lanes on the stream axis of the fused bits
kernel, so one ``ops.chaotic_bits`` launch advances every client at once.

Determinism contract: a client's word stream depends only on (weights,
seed, lanes_per_client, compute unit, dtype), never on which other
clients are registered or how requests interleave.  It holds because every
lane evolves independently in the kernel, each client carries its own
word-row (Weyl) counter, passed as a per-lane offset vector, and overdraw
from batched launches is buffered per client, not dropped.  The same
property makes the service resumable (``snapshot``/``restore``).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ann import params_from_numpy
from repro_torch.core.dse import resolve_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.prng.stream import (_lineage_counter, _round_rows,
                                     _splitmix_seeds, effective_burn_in)


@dataclasses.dataclass(eq=False)
class _Client:
    name: str
    slot: int                 # lane block index into the pool
    seed: int
    row: int = 0              # word rows emitted (per-lane Weyl counter)
    buf: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.uint32))
    pending: int = 0          # words requested but not yet delivered


class PRNGService:
    """Batches many named client streams onto one fused-kernel launch.

    Given no ``config``, the kernel config is the JAX package's choice for
    one client's ``lanes_per_client`` lanes (``core.dse.resolve_config``),
    so the service serves the JAX service's default stream.  On the card
    its kernels' shape library is built here (``ops.prepare``), so no
    flush waits on ``nvcc``.
    """

    def __init__(self, params, *, lanes_per_client: int = 128,
                 burn_in: int = 16, activation: str = "relu",
                 backend: str = "auto", config=None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.params = params_from_numpy(params, device=self.device)
        self.dim = self.params["w1"].shape[0]
        self.lanes_per_client = int(lanes_per_client)
        self.burn_in = effective_burn_in(burn_in)
        self.activation = activation
        self.backend = backend
        self.dtype = dtype
        self.config = resolve_config(config, self.params, dtype,
                                     s_total=self.lanes_per_client)
        if backend == "auto":   # this core's kernels, built before a flush
            ops.prepare(ops.kernel_shapes(self.params,
                                          self.config.compute_unit),
                        device=self.device)
        self.clients: Dict[str, _Client] = {}
        self.pool_x: Optional[torch.Tensor] = None    # (n_clients * L, I)
        self.launches = 0                             # batched pool launches
        # Optional observation hook: called with each launch's raw word
        # slab inside absorb(), off the delivery path (the farm's
        # health-monitoring seam, ``OscillatorFarm.attach_monitor``).  It
        # must be cheap and thread-safe: under an offloaded front-end,
        # absorb() runs on the launch executor thread.
        self.sample_hook = None
        # Words already served by a flush but not yet returned to their
        # requester (a draw() for one client must not drop co-tenants'
        # flushed requests).
        self._outbox: Dict[str, np.ndarray] = {}

    # -- registration -------------------------------------------------------

    def register(self, name: str, seed: Optional[int] = None) -> None:
        """Add a named stream: seed its lane block, burn it in, join pool.

        With no explicit seed, one is derived from the client name.
        """
        if name in self.clients:
            raise ValueError(f"client {name!r} already registered")
        if seed is None:
            seed = zlib.crc32(name.encode())
        x = _splitmix_seeds(_lineage_counter(seed, ()), self.lanes_per_client,
                            self.dim, self.device).to(self.dtype)
        if self.burn_in:
            # Dedicated small launch: burn-in never advances other clients.
            _, x = ops.chaotic_bits(self.params, x, self.burn_in, 0,
                                    activation=self.activation,
                                    backend=self.backend, config=self.config)
        self.clients[name] = _Client(name=name, slot=len(self.clients),
                                     seed=seed)
        self.pool_x = x if self.pool_x is None else torch.cat(
            [self.pool_x, x], dim=0)

    # -- request/flush ------------------------------------------------------

    def request(self, name: str, n_words: int) -> None:
        """Queue a draw; all queued draws are served by one flush() launch."""
        if n_words < 0:
            raise ValueError(f"n_words must be >= 0, got {n_words}")
        self.clients[name].pending += int(n_words)

    def rows_needed(self) -> int:
        """Unrounded max word rows any pending request still needs."""
        return self.rows_needed_with(None)

    def rows_needed_with(self, extra: Optional[Dict[str, int]] = None) -> int:
        """``rows_needed()`` if ``extra`` words per client were also pending."""
        L = self.lanes_per_client
        extra = extra or {}
        n_rows = 0
        for c in self.clients.values():
            need = c.pending + extra.get(c.name, 0) - len(c.buf)
            if need > 0:
                n_rows = max(n_rows, -(-need // L))
        return n_rows

    def pending_words(self, name: str) -> int:
        return self.clients[name].pending

    def outbox_words(self, name: str) -> int:
        parked = self._outbox.get(name)
        return 0 if parked is None else int(parked.size)

    def prepare_rows(self) -> Tuple[int, Optional[np.ndarray]]:
        """Plan a pool launch without performing it: (rows needed, the
        (S_pool,) uint32 per-lane Weyl offsets), or (0, None)."""
        n_rows = self.rows_needed()
        if n_rows == 0:
            return 0, None
        offsets = np.repeat(
            np.asarray([c.row for c in self._by_slot()], np.uint32),
            self.lanes_per_client)
        return n_rows, offsets

    def absorb(self, words: Optional[np.ndarray],
               new_pool_x: Optional[torch.Tensor], n_rows: int, *,
               deliver: bool = True) -> Dict[str, np.ndarray]:
        """Fold one launch's output back in, then deliver what is covered.

        ``words`` is the (n_rows, S_pool) uint32 slab and ``new_pool_x``
        the advanced state.  Clients that needed words get them buffered
        and their counters advanced; idle clients are frozen: their lanes
        rode the launch but are rolled back to the current pool.  With
        ``deliver=False`` served words are parked in the outbox instead.
        """
        L = self.lanes_per_client
        if n_rows > 0:
            words = np.asarray(words)
            if self.sample_hook is not None:
                self.sample_hook(words)
            active = [c for c in self._by_slot() if c.pending - len(c.buf) > 0]
            for c in active:
                mine = words[:, c.slot * L:(c.slot + 1) * L].reshape(-1)
                c.buf = np.concatenate([c.buf, mine])
                c.row += n_rows
            active_slots = {c.slot for c in active}
            if len(active_slots) < len(self.clients):
                idle = torch.as_tensor(np.concatenate(
                    [np.arange(c.slot * L, (c.slot + 1) * L)
                     for c in self._by_slot() if c.slot not in active_slots]),
                    device=self.device)
                new_pool_x = new_pool_x.clone()
                new_pool_x[idle] = self.pool_x[idle]
            self.pool_x = new_pool_x
        out: Dict[str, np.ndarray] = dict(self._outbox)
        self._outbox = {}
        for c in self.clients.values():
            if c.pending:
                served = c.buf[:c.pending]
                out[c.name] = (np.concatenate([out[c.name], served])
                               if c.name in out else served)
                c.buf = c.buf[c.pending:]
                c.pending = 0
        if deliver:
            return out
        for name, served in out.items():
            self.park(name, served)
        return {}

    def flush(self) -> Dict[str, np.ndarray]:
        """One batched kernel launch serving every pending request
        (``prepare_rows()`` -> launch -> ``absorb()``)."""
        n_need, offsets = self.prepare_rows()
        n_rows = _round_rows(n_need, self.config.t_block) if n_need else 0
        if n_rows > 0:
            words, new_x = self._launch(n_rows, offsets)
            return self.absorb(words, new_x, n_rows)
        return self.absorb(None, None, 0)

    def draw(self, name: str, n_words: int) -> np.ndarray:
        """Request + flush for one client; words the flush served for
        other clients (or earlier requests of this one) go to the outbox."""
        self.request(name, n_words)  # validates the client name
        if n_words == 0:
            return np.empty(0, np.uint32)
        prior = self.clients[name].pending - n_words
        out = self.flush()
        mine = out.pop(name)
        if prior > 0:
            self.park(name, mine[:prior])
            mine = mine[prior:]
        for other, words in out.items():
            self.park(other, words)
        return mine

    def park(self, name: str, words: np.ndarray) -> None:
        """Append already-served words to this client's outbox (delivered,
        outbox-first, by the next flush()/draw())."""
        if words.size == 0:
            return
        self._outbox[name] = (np.concatenate([self._outbox[name], words])
                              if name in self._outbox else words)

    def _by_slot(self) -> List[_Client]:
        return sorted(self.clients.values(), key=lambda c: c.slot)

    def _launch(self, n_rows: int, offsets: np.ndarray):
        """The one batched pool launch: ((n_rows, S_pool) words on the
        host, new state).  ``absorb()`` assigns ``pool_x``."""
        off = torch.as_tensor(offsets.astype(np.int64), device=self.device)
        words, new_x = ops.chaotic_bits(
            self.params, self.pool_x, 2 * n_rows, off,
            activation=self.activation, backend=self.backend,
            config=self.config)
        self.launches += 1
        return words.cpu().numpy(), new_x

    # -- resumability -------------------------------------------------------

    def replay_client(self, name: str, *, row: int, pending: int = 0,
                      buf_words: int = 0, outbox_words: int = 0,
                      chunk_rows: int = 4096) -> None:
        """Advance a client to an absolute stream position (crash recovery).

        Recomputes the client's lanes forward from its current row with the
        same fused kernel; chunk-invariant row indexing makes the replay
        bit-identical to the original launches, so the final
        ``buf_words + outbox_words`` regenerated words rebuild the
        undelivered tail exactly (order: [delivered][outbox][buffer]).
        """
        c = self.clients[name]
        row, buf_words, outbox_words = int(row), int(buf_words), int(outbox_words)
        if row < c.row:
            raise ValueError(
                f"replay_client({name!r}) cannot rewind: client is at row "
                f"{c.row}, journal says {row}")
        L = self.lanes_per_client
        if row * L < buf_words + outbox_words:
            raise ValueError(
                f"inconsistent position for {name!r}: {row} rows emit "
                f"{row * L} words < buf {buf_words} + outbox {outbox_words}")
        tail_need = buf_words + outbox_words
        held = np.concatenate([self._outbox.pop(name, np.empty(0, np.uint32)),
                               c.buf])
        if tail_need > held.size + (row - c.row) * L:
            raise ValueError(
                f"inconsistent position for {name!r}: owed tail "
                f"{tail_need} exceeds held {held.size} + "
                f"{(row - c.row) * L} replayable words")
        tail = held[-tail_need:] if tail_need else np.empty(0, np.uint32)
        if row > c.row:
            lanes = slice(c.slot * L, (c.slot + 1) * L)
            x = self.pool_x[lanes].contiguous()
            done = c.row
            while done < row:
                n = min(int(chunk_rows), row - done)
                words, x = ops.chaotic_bits(
                    self.params, x, 2 * n, done, activation=self.activation,
                    backend=self.backend, config=self.config)
                if tail_need:
                    tail = np.concatenate(
                        [tail, words.cpu().numpy().reshape(-1)])[-tail_need:]
                done += n
            self.pool_x = self.pool_x.clone()
            self.pool_x[lanes] = x
            c.row = row
        if outbox_words:
            self.park(name, tail[:outbox_words])
        c.buf = tail[outbox_words:]
        c.pending = int(pending)

    def snapshot(self) -> Dict[str, object]:
        """Serializable state: restore() continues every stream bit-exactly.

        The pool is stored as float32 numpy (exact for a bf16 pool).
        """
        pool = (self.pool_x.to("cpu", torch.float32).numpy()
                if self.pool_x is not None else None)
        return {
            "pool_x": pool,
            "clients": {
                c.name: {"slot": c.slot, "seed": c.seed, "row": c.row,
                         "buf": c.buf.copy(), "pending": c.pending}
                for c in self.clients.values()
            },
            "launches": self.launches,
            "outbox": {k: v.copy() for k, v in self._outbox.items()},
            "burn_in": self.burn_in,
        }

    def restore(self, snap: Dict[str, object]) -> None:
        snap_burn = snap.get("burn_in")
        if snap_burn is not None and int(snap_burn) != self.burn_in:
            raise ValueError(
                f"snapshot was taken with effective burn_in {snap_burn}, "
                f"this service runs {self.burn_in}; streams would resume "
                f"at positions the engine cannot reproduce")
        self.pool_x = (torch.as_tensor(np.asarray(snap["pool_x"]),
                                       device=self.device).to(self.dtype)
                       if snap["pool_x"] is not None else None)
        self.clients = {
            name: _Client(name=name, slot=st["slot"], seed=st["seed"],
                          row=st["row"], buf=np.asarray(st["buf"], np.uint32),
                          pending=int(st.get("pending", 0)))
            for name, st in snap["clients"].items()
        }
        self.launches = int(snap["launches"])
        self._outbox = {k: np.asarray(v, np.uint32)
                        for k, v in snap.get("outbox", {}).items()}
