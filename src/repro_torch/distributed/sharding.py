"""The port's device mesh and stream-pool sharding (port of the PRNG part
of ``repro/distributed/sharding.py``).

``DeviceMesh`` is one process over a list of ``torch.device``s along one
named axis, the counterpart of a 1-D ``jax.sharding.Mesh``: no
``torch.distributed``, no collectives.  A sharded launch splits its lane
axis into one contiguous shard per mesh entry, launches each shard's
kernel on that entry's device (on its current stream), and gathers the
words and states back onto the device the pool came from, the mesh's
first.  So a pool's state lives gathered on ``devices[0]`` between
flushes, and each flush copies every other device's shard there and
back (``copied_bytes`` counts those device-to-device bytes; a shard on
the pool's own device copies nothing).  Entries may repeat: ``[cpu] * 4``
is the counterpart of the JAX suite's forced host devices, and
``[cuda:0] * 4`` partitions a launch four ways on one card, its shards
queued one after another on the card's stream.

Weights are replicated: ``replicate`` copies a tensor to a device once
and keeps the copy while the tensor lives unchanged, so a flush copies
no weights.  Sharding never changes a word: lanes evolve independently
and each word's whitening reads its lane's absolute row offset.

The rest of the JAX module (``MeshSpec``, ``plan_params``,
``plan_batch``, ``plan_decode_state``, ``make_shard_fn``, ``named``,
``strip_dp_axes``) serves the LM stack and is not ported here (ROADMAP.md
queue 1 item 7).
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

# weight tensors whose per-device copies a mesh keeps (a farm's stacked
# plans and its services' weights, with room to spare)
MAX_REPLICAS = 256


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` without an index names the current card; tensors report
    the index, so the mesh keeps it explicit for equality tests."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class DeviceMesh:
    """A list of devices along one named axis (``shape[axis]`` entries).

    Every entry goes through ``resolve_device``, so a mesh that names a
    missing card raises.  ``shard_launches[d]`` counts the shards run on
    entry ``d``; ``copied_bytes`` the bytes its shards and replicas moved
    between devices.
    """

    def __init__(self, devices: Sequence, axis: str = "data"):
        devs = tuple(_indexed(resolve_device(d)) for d in devices)
        if not devs:
            raise ValueError("a device mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = devs
        self.axis = str(axis)
        self.shape = {self.axis: len(devs)}
        self.shard_launches = [0] * len(devs)
        self.copied_bytes = 0
        self._replicas: "collections.OrderedDict[int, tuple]" = (
            collections.OrderedDict())
        self._lock = threading.Lock()

    def __repr__(self) -> str:
        return (f"DeviceMesh([{', '.join(map(str, self.devices))}], "
                f"axis={self.axis!r})")

    @property
    def ids(self) -> Tuple[int, ...]:
        """Each entry's device index, 0 for the CPU (a JAX device id)."""
        return tuple(0 if d.index is None else int(d.index)
                     for d in self.devices)

    def to(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        """``t`` on ``device``; a copy between devices is counted."""
        if t.device == device:
            return t
        with self._lock:
            self.copied_bytes += t.numel() * t.element_size()
        return t.to(device)

    def replicate(self, t, device: torch.device):
        """``t`` on ``device``, copied once per (tensor, device) while the
        tensor lives unchanged (its version counter), the last
        ``MAX_REPLICAS`` tensors kept.  Anything but a tensor, or a tensor
        already there, is returned as it is."""
        if not isinstance(t, torch.Tensor) or t.device == device:
            return t
        with self._lock:
            key = id(t)
            entry = self._replicas.get(key)
            if entry is None or entry[0] is not t or entry[1] != t._version:
                entry = (t, t._version, {})
                self._replicas[key] = entry
                while len(self._replicas) > MAX_REPLICAS:
                    self._replicas.popitem(last=False)
            self._replicas.move_to_end(key)
            copies = entry[2]
            if device not in copies:
                self.copied_bytes += t.numel() * t.element_size()
                copies[device] = t.to(device)
            return copies[device]


def shard_stream_pool(fn: Callable, mesh: DeviceMesh) -> Callable:
    """Shard a PRNG stream-pool launch over the stream (lane) axis.

    ``fn(x, offsets) -> (words, state)`` with x (S, I), offsets (S,),
    words (rows, S) and state (S, I), all on one device; ``fn`` reads
    anything else it needs (the weights) for ``x.device``.  The returned
    callable splits S into one equal contiguous shard a mesh entry,
    runs ``fn`` on each shard on its entry's device, and gathers the words
    on the lane axis and the state on the stream axis, on the device of
    ``x``.  Oscillator lanes evolve independently, so the result is the
    unsharded launch's.  The entry count must divide S.
    """
    n_dev = len(mesh.devices)

    def run(x: torch.Tensor, offsets) -> Tuple[torch.Tensor, torch.Tensor]:
        s_total = x.shape[0]
        if s_total % n_dev:
            raise ValueError(f"stream pool of {s_total} lanes does not "
                             f"divide {n_dev} devices on mesh axis "
                             f"{mesh.axis!r}")
        off = torch.broadcast_to(torch.as_tensor(offsets, device=x.device),
                                 (s_total,))
        per = s_total // n_dev
        words, state = [], []
        for d, dev in enumerate(mesh.devices):
            lanes = slice(d * per, (d + 1) * per)
            w, s = fn(mesh.to(x[lanes], dev),
                      mesh.to(off[lanes].contiguous(), dev))
            mesh.shard_launches[d] += 1
            words.append(mesh.to(w, x.device))
            state.append(mesh.to(s, x.device))
        return torch.cat(words, dim=1), torch.cat(state, dim=0)

    return run
