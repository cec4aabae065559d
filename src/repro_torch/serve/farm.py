"""Heterogeneous oscillator farm: many generated cores, one serving API
(port of ``repro/serve/farm.py``).

Each core is backed by its own ``PRNGService`` pool, and every
determinism/resumability guarantee of ``PRNGService`` carries over: a
client's words are identical whether served standalone or through the
farm.

**Gang scheduling**: compatible cores (same (i_dim, h_dim, dtype,
activation, backend, kernel config, lattice descriptor)) do not each pay
their own launch per flush.  ``GangScheduler`` stacks their weights along
a leading core axis and issues ONE gang launch for the group (the stacked
kernel K4 for equal pools, the lane-concat kernel K3 otherwise or for
demand-shaped launches), then scatters words and final states back to
each service through its ``prepare_rows()/absorb()`` halves.  Lanes
evolve independently and word emission is defined in absolute word-row
space, so per-client words are bit-identical to the per-core path.

**Activations**: the activation is part of the key, so tanh cores gang
with tanh cores and sigmoid with sigmoid (a directory of generated relu,
tanh and sigmoid cores on one config makes one group per activation).
Every group runs its gang kernel with its activation, as the JAX farm
does: a vpu group, scalar or lattice, K3/K4 (or their lattice forms); an
mxu group K3's mxu form (no-config ``<system>@ring32`` cores of relu,
tanh and sigmoid nets make three mxu groups).

**Lattice cores** (``lattice_meta`` in their params) gang only with
lattice cores of the same descriptor (n_nodes, base_dim, topology,
strength), never with scalar cores; a vpu lattice group runs the lattice
forms of K3 and K4.  The plan carries ``coupling`` and ``lattice_meta``
un-stacked from its first member, as the JAX plan does.

**mxu groups** (scalar or lattice; a lattice core given no config is one,
since ``select_config`` puts ``chen@ring32`` on the mxu unit) always take
the lane-concat layout: K4 has no mxu form, so ``stackable`` requires the
vpu, and every mxu gang is one launch of K3's mxu form with the plan's
one shared ``coupling``, as in the JAX farm.

**The stacked layout differs from the JAX planner's.**  The JAX farm also
requires the C-tall stack to fit VMEM (``stacked_gang_vmem_bytes <=
VMEM_USABLE``); on Hopper each K4 CTA holds one core's weights and its
lanes' states live in registers, so there is no such cliff, and the only
limit is the grid's y extent (65,535 cores).  From 69 chen@ring32
members in f32 (126 in bf16, on ``default_config(96, 256, dtype,
n_nodes=32)``) the port's plan therefore stays stacked where the JAX
farm's goes to lane-concat: ``plan_decisions`` and launch counts can
differ from the JAX farm's, the words cannot (gang and solo words are
bitwise equal).

**Supervision seams**, as in the JAX farm: ``faults=`` (a
``serve.faults.FaultPlan``) is called before every group, solo and
``gang=False`` launch does any work and at every flush, and
``attach_monitor`` installs a sampling hook on every core's service that
feeds each launch's word slab (through the plan's sample corruption) into
a ``serve.health.HealthMonitor``; ``quarantine`` and ``rotate`` reset the
monitor's history of the core.

**Across devices**, as in the JAX farm: a core attached with a ``mesh``
(``distributed.sharding.DeviceMesh``) serves from a pool on the mesh's
first device, and its launches shard across the mesh.  The device
topology (axis, device count, device ids) is part of the compat key, so
cores on the SAME mesh gang, and the group launches as one sharded K3 or
K4 across it; the planner prices the busiest shard plus a cross-device
fee (``GangCostModel``'s ``n_dev``) and takes the stacked layout only
where the equal pools divide the devices.  ``snapshot`` records each
core's topology (``None`` for an unmeshed pool), and ``restore`` refuses
a snapshot taken on another topology unless asked to re-plan.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.clock import Clock, SystemClock
from repro_torch.core.ann import check_block_diagonal, lattice_meta_tuple
from repro_torch.core.dse import LANES, Candidate, GangCostModel, _pad
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.chaotic_ann import gang_effective_rows
from repro_torch.prng.stream import _round_rows
from repro_torch.serve.health import CoreQuarantined
from repro_torch.serve.prng_service import PRNGService

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _topology(svc: PRNGService) -> Optional[Tuple]:
    """Hashable device-axis signature of a service's mesh: ``None`` for
    an unmeshed pool, else the axis name, its device count and each
    entry's device index (0 for the CPU), as the JAX farm's device ids.
    Part of every gang compat key and farm snapshot, so nothing planned
    on one device count serves another."""
    if svc.mesh is None:
        return None
    return (svc.mesh.axis, len(svc.mesh.devices), svc.mesh.ids)


def _as_topo(t) -> Optional[Tuple]:
    """Canonicalize a topology signature (JSON round-trips turn the tuples
    into lists; journal checkpoints compare through this)."""
    if t is None:
        return None
    return (str(t[0]), int(t[1]), tuple(int(x) for x in t[2]))


def _lattice_sig(svc: PRNGService) -> Optional[Tuple]:
    """Hashable lattice identity of one core's service, or ``None`` for a
    scalar (uncoupled) core.  The coupling operator is a pure function of
    this tuple (``lattice_coupling_matrix``), so equal signatures imply a
    shared coupling operand is exact for every member of a gang."""
    meta = svc.params.get("lattice_meta")
    if meta is None:
        return None
    return lattice_meta_tuple(np.asarray(meta))


def _compat_key(svc: PRNGService) -> Tuple:
    """Gang-compatibility signature of one core's service.

    Two cores may share a stacked-weight launch iff every static property
    of the kernel instantiation matches: network shape (i_dim, h_dim),
    state dtype, activation, backend, the full kernel config (s_block,
    t_block, unroll, compute_unit), the lattice signature (scalar cores
    never gang with lattice cores, and lattice cores gang only on an
    identical (n_nodes, base_dim, topology, strength)) and the device
    topology: meshed pools gang with pools on the SAME mesh (axis name,
    device count, device ids), as one sharded launch across it.
    """
    c = svc.config
    return (svc.dim, int(svc.params["w1"].shape[1]), str(svc.dtype),
            svc.activation, svc.backend,
            c.s_block, c.t_block, c.unroll, c.compute_unit,
            _lattice_sig(svc), _topology(svc))


class GangScheduler:
    """Launches a group of compatible cores as stacked-weight kernels,
    choosing HOW per flush with a launch-cost model (the gang *planner*).

    Three caches keep steady-state traffic replay-only:

    * plan cache: per (group, membership, layout), the stacked weights,
      the pool layout (lane spans + per-block core-id map), reusable
      offset / dead-lane padding buffers, and the last launch's stacked
      device state (reused as the next x0 when no absorb rewrote any
      member pool);
    * decision cache: per (membership, ``_round_rows``-bucketed per-core
      demand vector), the cost-minimizing choice among ONE padded
      group-max launch, ONE ragged launch (each lane block computes only
      its own demand), or a SPLIT into demand-homogeneous sub-launches;
    * dispatch keys: distinct (plan, rows, ragged) launch shapes ever
      issued.  PyTorch compiles nothing per shape; the count is kept for
      the JAX API and to show steady state stops growing it.

    ``planner=False`` pins every decision to the padded group-max launch.
    """

    def __init__(self, cost_model: Optional[GangCostModel] = None,
                 planner: bool = True, clock: Optional[Clock] = None,
                 faults=None):
        self.clock: Clock = clock or SystemClock()
        self.faults = faults          # FaultPlan (chaos harness) or None
        self._plans: Dict[Tuple, Dict] = {}
        self._decisions: Dict[Tuple, Dict] = {}
        self._dispatch_keys = set()   # (plan key, n_rows, ragged) launched
        self.launches = 0
        self.planner = bool(planner)
        self.cost_model = cost_model or GangCostModel()
        self.decisions = {"padded": 0, "ragged": 0, "split": 0}
        # flushes where an SLO class actually constrained the choice set
        self.slo_forced = {"latency": 0, "bulk": 0}
        self.profile: Optional[Dict[str, float]] = None

    @property
    def dispatch_misses(self) -> int:
        """Distinct (group, rows, ragged) launch shapes issued so far."""
        return len(self._dispatch_keys)

    def _tick(self, stage: str, t0: float) -> float:
        t1 = self.clock.now()
        if self.profile is not None:
            self.profile[stage] = self.profile.get(stage, 0.0) + (t1 - t0)
        return t1

    def _plan(self, key: Tuple, members: List[Tuple[str, PRNGService]],
              mode: str) -> Dict:
        """Stacked weights + pool layout for one (membership, layout).

        'stacked' (equal-size vpu pools) takes K4 with one (C, S, I) pool
        stack; 'concat' takes K3, member pools padded to whole lane blocks
        and concatenated, with a per-block core-id map.  A lattice group
        carries ``coupling`` and ``lattice_meta`` un-stacked (the compat
        key pins one descriptor), and its stacked weights are checked
        block-diagonal here, once per plan: the lattice kernels read only
        the diagonal node blocks of every core.
        """
        sig = (key, tuple((name, int(svc.pool_x.shape[0]))
                          for name, svc in members), mode)
        plan = self._plans.get(sig)
        if plan is not None:
            return plan
        svc0 = members[0][1]
        s_block = svc0.config.s_block
        params = {k: torch.stack([svc.params[k] for _, svc in members])
                  for k in ("w1", "b1", "w2", "b2")}
        for k in ("coupling", "lattice_meta"):
            if k in svc0.params:
                params[k] = svc0.params[k]
        if "lattice_meta" in params:
            check_block_diagonal(params["w1"], params["w2"],
                                 lattice_meta_tuple(params["lattice_meta"])[0])
        sizes = [int(svc.pool_x.shape[0]) for _, svc in members]
        plan = {"sig": sig, "params": params, "s_block": s_block,
                "mode": mode, "last_x": None, "handed": None}
        if mode == "stacked":
            plan["offs_buf"] = np.zeros((len(members), sizes[0]), np.uint32)
        else:
            spans, core_map, pads, start = [], [], [], 0
            for ci, live in enumerate(sizes):
                padded = -(-live // s_block) * s_block
                spans.append((start, live, padded))
                core_map.extend([ci] * (padded // s_block))
                if padded > live:  # dead-lane padding, built once
                    pads.append(torch.zeros((padded - live, svc0.dim),
                                            dtype=svc0.dtype,
                                            device=svc0.device))
                else:
                    pads.append(None)
                start += padded
            plan.update(spans=spans, pads=pads,
                        core_map=np.asarray(core_map, np.int32),
                        offs_buf=np.zeros(start, np.uint32))
        self._plans[sig] = plan
        return plan

    # -- planning ------------------------------------------------------------

    def _decide(self, key: Tuple, members: Sequence[Tuple],
                demands: Tuple[int, ...],
                slo: Optional[str] = None) -> Dict:
        """Pick the cost-minimizing launch shape for one flush.

        ``demands`` are the ``_round_rows``-bucketed per-member word rows;
        the decision is cached on (membership, demands, slo).  Candidate
        plans:

        * ``padded``: one launch, every member at the group max (stacked
          when pools are equal + vpu, else lane-concat); the only option
          with ``planner=False``;
        * ``ragged``: one demand-shaped launch (stacked-with-freeze or
          lane-concat-with-early-out, whichever models cheaper);
        * ``split``: demand-homogeneous subgroups, each padded (solo
          per-core launches for singletons).

        ``slo`` constrains the choice set: ``"latency"`` forbids the
        padded group-max launch whenever demand is skewed; ``"bulk"`` pins
        it.  ``None`` leaves the planner free.

        The stacked layout needs equal pools, the vpu unit and, on a mesh
        of ``n_dev`` devices, a pool size that ``n_dev`` divides (the
        sharded K4 splits each pool's lanes); every cost is the model's
        at ``n_dev``.  The JAX check that the C-tall stack fits VMEM has
        no counterpart, because each K4 CTA holds one core's weights and
        its lanes' states live in registers, whatever C is (so from 69
        f32 ring32 members this plan stays stacked where the JAX one goes
        to concat; see the module docstring).
        """
        if not self.planner:
            slo = None
        mem_sig = (key, tuple((name, int(svc.pool_x.shape[0]))
                              for name, svc, _, _ in members))
        dsig = (mem_sig, demands, slo)
        dec = self._decisions.get(dsig)
        if dec is not None:
            return dec
        svc0 = members[0][1]
        c = svc0.config
        sizes = [int(svc.pool_x.shape[0]) for _, svc, _, _ in members]
        blocks = [-(-s // c.s_block) for s in sizes]
        topo = _topology(svc0)
        n_dev = 1 if topo is None else topo[1]

        def stackable(idxs) -> bool:
            return (len({sizes[i] for i in idxs}) == 1
                    and c.compute_unit == "vpu"
                    and sizes[idxs[0]] % n_dev == 0)

        model = self.cost_model
        all_idx = tuple(range(len(members)))
        stacked_ok = stackable(all_idx)
        dmax = max(demands)
        base_layout = "stacked" if stacked_ok else "concat"
        options = [("padded",
                    model.gang_cost(c, demands, blocks, sizes,
                                    layout=base_layout, n_dev=n_dev),
                    [{"members": all_idx, "kind": "gang",
                      "layout": base_layout, "ragged": False}])]
        if self.planner and len(set(demands)) > 1:
            # one ragged launch: early-out concat vs freeze-stacked
            eff = gang_effective_rows(
                np.repeat(np.asarray(demands), blocks), 2 * dmax,
                c.t_block, c.unroll)
            r_cost = model.gang_cost(c, demands, blocks, sizes,
                                     layout="concat",
                                     rows_by_block=[int(r) for r in eff],
                                     n_dev=n_dev)
            r_layout = "concat"
            if stacked_ok:
                s_cost = model.gang_cost(c, demands, blocks, sizes,
                                         layout="stacked",
                                         rows_by_block=list(demands),
                                         n_dev=n_dev)
                # the freeze layout must beat the early-out concat path by
                # a clear modeled margin
                if s_cost < 0.9 * r_cost:
                    r_cost, r_layout = s_cost, "stacked"
            options.append(("ragged", r_cost,
                            [{"members": all_idx, "kind": "gang",
                              "layout": r_layout, "ragged": True}]))
            # split into demand-homogeneous subgroups
            by_demand: Dict[int, List[int]] = {}
            for i, d in enumerate(demands):
                by_demand.setdefault(d, []).append(i)
            cost, parts = 0.0, []
            for d in sorted(by_demand, reverse=True):
                idxs = by_demand[d]
                if len(idxs) == 1:
                    i = idxs[0]
                    cost += model.solo_cost(c, d, blocks[i], n_dev=n_dev)
                    parts.append({"members": (i,), "kind": "solo"})
                else:
                    lay = "stacked" if stackable(idxs) else "concat"
                    cost += model.gang_cost(
                        c, [d] * len(idxs), [blocks[i] for i in idxs],
                        [sizes[i] for i in idxs], layout=lay, n_dev=n_dev)
                    parts.append({"members": tuple(idxs), "kind": "gang",
                                  "layout": lay, "ragged": False})
            options.append(("split", cost, parts))
        free_kind = min(options, key=lambda o: o[1])[0]
        eligible = options
        if slo == "bulk":
            eligible = [o for o in options if o[0] == "padded"]
        elif slo == "latency" and len(options) > 1:
            eligible = [o for o in options if o[0] != "padded"]
        kind, cost, parts = min(eligible, key=lambda o: o[1])
        if slo is not None and kind != free_kind:
            self.slo_forced[slo] += 1
        dec = {"kind": kind, "parts": parts, "slo": slo,
               "modeled_cycles": {k: v for k, v, _ in options}}
        self._decisions[dsig] = dec
        return dec

    # -- execution -----------------------------------------------------------

    def _gather_x0(self, plan: Dict, members: Sequence[Tuple]):
        """The launch's pooled x0; reuses the last launch's stacked device
        state when every member pool is still the exact tensor this
        scheduler handed to its ``absorb`` (identity check: any rollback,
        which clones, any restore or registration rebuilds)."""
        handed = plan["handed"]
        if (handed is not None and len(handed) == len(members)
                and all(svc.pool_x is h
                        for (_, svc, _, _), h in zip(members, handed))):
            return plan["last_x"]
        if plan["mode"] == "stacked":
            return torch.stack([svc.pool_x for _, svc, _, _ in members])
        parts = []
        for pad, (_, svc, _, _) in zip(plan["pads"], members):
            parts.append(svc.pool_x)
            if pad is not None:
                parts.append(pad)
        return torch.cat(parts, dim=0)

    def _launch_group(self, key: Tuple, members: Sequence[Tuple],
                      demands: Sequence[int], *, layout: str, ragged: bool,
                      deliver: bool) -> Dict[str, Dict[str, np.ndarray]]:
        """One gang launch (padded or ragged) for ``members``."""
        if self.faults is not None:
            # the injection seam sits BEFORE any kernel work or absorb
            # bookkeeping: a failed launch leaves every member's demand
            # parked at the same absolute rows, so a retry is bit-exact
            self.faults.on_launch([name for name, _, _, _ in members])
        t0 = self.clock.now()
        svc0 = members[0][1]
        cfg = svc0.config
        plan = self._plan(key, [(name, svc) for name, svc, _, _ in members],
                          layout)
        n_rows = max(demands)
        n_steps = 2 * n_rows
        t0 = self._tick("plan", t0)
        x0 = self._gather_x0(plan, members)
        offs = plan["offs_buf"]
        if layout == "stacked":
            for ci, (_, _, _, offsets) in enumerate(members):
                offs[ci, :] = offsets
            row_map = np.asarray(demands, np.int32) if ragged else None
            member_rows = list(demands) if ragged else [n_rows] * len(members)
            off_t = torch.as_tensor(offs.astype(np.int64), device=svc0.device)
            t0 = self._tick("stack", t0)
            words, state = ops.chaotic_bits_gang_stacked(
                plan["params"], x0, n_steps, off_t, row_map=row_map,
                activation=svc0.activation, backend=svc0.backend,
                mesh=svc0.mesh, config=cfg)
            words = words.cpu().numpy()
            handed = [state[ci] for ci in range(len(members))]
            member_out = [(words[:member_rows[ci], ci, :], handed[ci])
                          for ci in range(len(members))]
        else:
            for (start, live, _), (_, _, _, offsets) in zip(
                    plan["spans"], members):
                offs[start:start + live] = offsets
            if ragged:
                block_demand = np.repeat(np.asarray(demands, np.int64),
                                         [padded // plan["s_block"]
                                          for _, _, padded in plan["spans"]])
                row_map = gang_effective_rows(block_demand, n_steps,
                                              cfg.t_block, cfg.unroll)
                # every block of a member shares its demand -> same rows
                member_rows, b0 = [], 0
                for _, _, padded in plan["spans"]:
                    member_rows.append(int(row_map[b0]))
                    b0 += padded // plan["s_block"]
            else:
                row_map = None
                member_rows = [n_rows] * len(members)
            off_t = torch.as_tensor(offs.astype(np.int64), device=svc0.device)
            t0 = self._tick("stack", t0)
            words, state = ops.chaotic_bits_gang(
                plan["params"], x0, n_steps, off_t,
                core_map=plan["core_map"], row_map=row_map,
                activation=svc0.activation, backend=svc0.backend,
                mesh=svc0.mesh, config=cfg)
            words = words.cpu().numpy()
            handed = [state[start:start + live]
                      for (start, live, _) in plan["spans"]]
            member_out = [(words[:member_rows[ci], start:start + live],
                           handed[ci])
                          for ci, (start, live, _) in enumerate(plan["spans"])]
        plan["last_x"], plan["handed"] = state, handed
        self.launches += 1
        self._dispatch_keys.add((plan["sig"], n_rows, bool(ragged)))
        t0 = self._tick("launch", t0)
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for (mwords, mstate), rows_c, (name, svc, _, _) in zip(
                member_out, member_rows, members):
            served = svc.absorb(mwords, mstate, rows_c, deliver=deliver)
            if served:
                out[name] = served
        self._tick("absorb", t0)
        return out

    def _launch_solo(self, member: Tuple, n_rows: int, *,
                     deliver: bool) -> Dict[str, Dict[str, np.ndarray]]:
        """A planner-split singleton: a plain per-core launch."""
        name, svc, _, offsets = member
        if self.faults is not None:
            self.faults.on_launch([name])
        t0 = self.clock.now()
        words, new_x = svc._launch(n_rows, offsets)
        t0 = self._tick("launch", t0)
        served = svc.absorb(words, new_x, n_rows, deliver=deliver)
        self._tick("absorb", t0)
        return {name: served} if served else {}

    def launch(self, key: Tuple,
               members: List[Tuple[str, PRNGService, int, np.ndarray]],
               *, deliver: bool = True,
               slo: Optional[str] = None) -> Dict[str, Dict[str, np.ndarray]]:
        """Serve one flush of ``members`` (each with its prepare_rows plan)
        with the planner-chosen launch shape.

        However the plan shapes launches, every member advances by a row
        count >= its own demand with overdraw buffered, so delivered words
        are bit-identical to the per-core path.
        """
        t0 = self.clock.now()
        svc0 = members[0][1]
        demands = tuple(_round_rows(n, svc0.config.t_block)
                        for _, _, n, _ in members)
        dec = self._decide(key, members, demands, slo)
        self.decisions[dec["kind"]] += 1
        self._tick("plan", t0)
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for part in dec["parts"]:
            sub = [members[i] for i in part["members"]]
            if part["kind"] == "solo":
                out.update(self._launch_solo(
                    sub[0], demands[part["members"][0]], deliver=deliver))
            else:
                out.update(self._launch_group(
                    key, sub, [demands[i] for i in part["members"]],
                    layout=part["layout"], ragged=part["ragged"],
                    deliver=deliver))
        return out


class OscillatorFarm:
    """Routes named clients to per-core ``PRNGService`` pools.

    ``gang=True`` (default) enables gang-scheduled flushes: compatible
    cores share one stacked-weight launch per flush.  ``gang=False`` runs
    one launch per core; delivered words are bit-identical either way.
    ``planner=True`` (default) lets the gang scheduler shape each group's
    launch to per-core demand with the ``GangCostModel`` (padded / ragged
    / split); ``planner=False`` pins the padded group-max policy.
    ``auto_flush_rows`` is the coalescing threshold for
    ``request(..., auto_flush=True)`` (None = flush on every auto-flush
    request).  ``profile=True`` accumulates per-stage flush wall times
    (plan / stack / launch / absorb) in ``profile_stats``, read through
    the injectable ``clock``.  Every core's pool lives on ``device``.
    ``faults`` is a ``FaultPlan`` (chaos harness) or None.
    """

    def __init__(self, *, gang: bool = True, planner: bool = True,
                 gang_cost_model: Optional[GangCostModel] = None,
                 auto_flush_rows: Optional[int] = None,
                 profile: bool = False, clock: Optional[Clock] = None,
                 faults=None, device="cuda"):
        self.device = resolve_device(device)
        self.services: Dict[str, PRNGService] = {}
        self.gang = bool(gang)
        self.auto_flush_rows = auto_flush_rows
        self.clock: Clock = clock or SystemClock()
        self.faults = faults
        self._sched = GangScheduler(cost_model=gang_cost_model,
                                    planner=planner, clock=self.clock,
                                    faults=faults)
        if profile:
            self._sched.profile = {"plan": 0.0, "stack": 0.0,
                                   "launch": 0.0, "absorb": 0.0,
                                   "flushes": 0.0}
        self._deferred: set = set()   # cores deferred by the last flush
        # quarantined cores are skipped by every flush; standbys are cold
        # spare services rotated into a quarantined core's routing slot
        self._quarantined: set = set()
        self._standbys: Dict[str, PRNGService] = {}
        self._rotations: Dict[str, int] = {}
        self.monitor = None           # HealthMonitor via attach_monitor()

    # -- core management ----------------------------------------------------

    def _service(self, params, *, config, dtype, activation,
                 lanes_per_client, burn_in, backend, mesh) -> PRNGService:
        return PRNGService(params, lanes_per_client=lanes_per_client,
                           burn_in=burn_in, activation=activation,
                           backend=backend, config=config,
                           dtype=dtype if dtype is not None else torch.float32,
                           device=self.device if mesh is None else None,
                           mesh=mesh)

    def add_core(self, core: str, params, *, config=None, dtype=None,
                 activation: str = "relu", lanes_per_client: int = 128,
                 burn_in: int = 16, backend: str = "auto",
                 mesh=None) -> PRNGService:
        """Attach a core (one oscillator network) as a serving pool;
        ``dtype`` None is float32.  On the card the core's kernels are built
        here, by its service (``ops.prepare``), not at a flush.  With a
        ``mesh`` the pool lives on the mesh's first device and its launches
        shard across the mesh."""
        if core in self.services:
            raise ValueError(f"core {core!r} already attached")
        svc = self._service(params, config=config, dtype=dtype,
                            activation=activation,
                            lanes_per_client=lanes_per_client,
                            burn_in=burn_in, backend=backend, mesh=mesh)
        self.services[core] = svc
        if self.monitor is not None:
            self._install_hook(core)
        return svc

    @classmethod
    def from_generated(cls, farm_dir: str | pathlib.Path,
                       cores: Optional[Iterable[str]] = None,
                       gang: bool = True, planner: bool = True,
                       gang_cost_model: Optional[GangCostModel] = None,
                       auto_flush_rows: Optional[int] = None,
                       profile: bool = False, clock: Optional[Clock] = None,
                       faults=None, device="cuda",
                       **service_kw) -> "OscillatorFarm":
        """Build a farm from a ``generate_farm`` output directory, read
        only: every subdirectory with weights.npz + solution.json becomes
        a core, and its frozen solution (kernel config, dtype, activation)
        drives that core's service.  On the card every core's kernels are
        built first, in one parallel build (``ops.prepare``).  One adjustment: the solution's stream
        block is clamped to one client's lane block; lanes evolve
        independently, so the clamp is bit-exact.
        """
        reserved = {"config", "dtype", "activation"} & set(service_kw)
        if reserved:
            raise ValueError(
                f"{sorted(reserved)} are replayed from each core's "
                f"solution.json and cannot be overridden here; use "
                f"add_core() to attach a core with custom values")
        farm_dir = pathlib.Path(farm_dir)
        farm = cls(gang=gang, planner=planner,
                   gang_cost_model=gang_cost_model,
                   auto_flush_rows=auto_flush_rows, profile=profile,
                   clock=clock, faults=faults, device=device)
        names = sorted(cores) if cores is not None else sorted(
            p.name for p in farm_dir.iterdir()
            if (p / "solution.json").exists() and (p / "weights.npz").exists())
        if not names:
            raise ValueError(f"no generated cores under {farm_dir}")
        lanes = service_kw.get("lanes_per_client", 128)
        p_cap = max(0, (_pad(lanes, LANES) // LANES).bit_length() - 1)
        cores = []
        for name in names:
            sol = json.loads((farm_dir / name / "solution.json").read_text())
            cand = Candidate(**sol["candidate"])
            cand = dataclasses.replace(cand, p=min(cand.p, p_cap))
            with np.load(farm_dir / name / "weights.npz") as npz:
                cores.append((name, dict(npz), cand, sol))
        if service_kw.get("backend", "auto") == "auto":
            # every core's kernels in one parallel build, before any service
            ops.prepare([key for _, params, cand, _ in cores
                         for key in ops.kernel_shapes(params,
                                                      cand.compute_unit)],
                        device=farm.device)
        for name, params, cand, sol in cores:
            farm.add_core(name, params, config=cand,
                          dtype=_DTYPES[cand.dtype_name],
                          activation=sol.get("activation", "relu"),
                          **service_kw)
        return farm

    @property
    def cores(self) -> Tuple[str, ...]:
        return tuple(self.services)

    def _svc(self, core: str) -> PRNGService:
        try:
            return self.services[core]
        except KeyError:
            raise KeyError(f"unknown core {core!r}; have {sorted(self.services)}")

    # -- self-healing: quarantine, standbys, rotation ------------------------

    @property
    def quarantined(self) -> frozenset:
        """Cores currently quarantined (skipped by every flush)."""
        return frozenset(self._quarantined)

    @property
    def rotations(self) -> Dict[str, int]:
        """Standby rotations performed so far, per logical core."""
        return dict(self._rotations)

    def add_standby(self, core: str, params, *, config=None, dtype=None,
                    activation: str = "relu", lanes_per_client: int = 128,
                    burn_in: int = 16, backend: str = "auto",
                    mesh=None) -> PRNGService:
        """Attach a cold standby service for logical core ``core``.  It
        serves no traffic until :meth:`rotate` installs it; a client
        re-registered on it restarts at row 0 of the standby's own
        deterministic stream."""
        if core not in self.services:
            raise KeyError(f"unknown core {core!r}; attach it before a "
                           f"standby")
        if core in self._standbys:
            raise ValueError(f"core {core!r} already has a standby")
        svc = self._service(params, config=config, dtype=dtype,
                            activation=activation,
                            lanes_per_client=lanes_per_client,
                            burn_in=burn_in, backend=backend, mesh=mesh)
        self._standbys[core] = svc
        return svc

    def has_standby(self, core: str) -> bool:
        return core in self._standbys

    def quarantine(self, core: str, reason: str = "") -> bool:
        """Take ``core`` out of service: every flush skips it, cached gang
        plans and planner decisions drop, and its undeliverable pending
        demand is cleared.  Idempotent: returns False when the core was
        already quarantined.  Words already parked in its outbox stay."""
        svc = self._svc(core)
        if core in self._quarantined:
            return False
        self._quarantined.add(core)
        for c in svc.clients.values():
            c.pending = 0
        self._deferred.discard(core)
        self._sched._plans.clear()
        self._sched._decisions.clear()
        if self.monitor is not None:
            self.monitor.reset(core)
        return True

    def rotate(self, core: str) -> PRNGService:
        """Install ``core``'s standby in its routing slot and lift the
        quarantine.  Every client of the old service is re-registered on
        the standby with its original seed.  Returns the replaced
        service."""
        standby = self._standbys.pop(core, None)
        if standby is None:
            raise ValueError(
                f"core {core!r} has no standby attached; add_standby() "
                f"a registry sibling before rotating")
        old = self._svc(core)
        for c in sorted(old.clients.values(), key=lambda c: c.slot):
            standby.register(c.name, seed=c.seed)
        self.services[core] = standby
        self._quarantined.discard(core)
        self._rotations[core] = self._rotations.get(core, 0) + 1
        self._sched._plans.clear()
        self._sched._decisions.clear()
        if self.monitor is not None:
            self.monitor.reset(core)
            self._install_hook(core)
        return old

    def attach_monitor(self, monitor) -> None:
        """Wire a ``HealthMonitor``: every core's service gets a sampling
        hook that feeds each launch's word slab (bounded, and run through
        the fault plan's sample corruption when one is attached) into
        ``monitor.ingest``, off the delivery path.  Under an offloaded
        front-end the hook runs on the launch executor thread; ``ingest``
        is thread-safe."""
        self.monitor = monitor
        for core in self.services:
            self._install_hook(core)

    def _install_hook(self, core: str) -> None:
        svc = self.services[core]
        monitor, faults = self.monitor, self.faults
        cap = int(monitor.window_words)
        if faults is not None:
            faults.bind(core, svc)

        def hook(slab, _core=core, _svc=svc):
            w = slab.reshape(-1)[:cap]
            if faults is not None:
                w = faults.corrupt_sample(_core, _svc, w)
            monitor.ingest(_core, w)

        svc.sample_hook = hook

    def _check_serving(self, core: str) -> None:
        if core in self._quarantined:
            raise CoreQuarantined(
                f"core {core!r} is quarantined (no standby rotated in); "
                f"resubmit on another core or after rotation",
                core=core, reason="quarantined")

    # -- client API (per-core routing) --------------------------------------

    def register(self, core: str, client: str,
                 seed: Optional[int] = None) -> None:
        """Register a named client stream on one core's pool."""
        self._check_serving(core)
        self._svc(core).register(client, seed=seed)

    def request(self, core: str, client: str, n_words: int,
                auto_flush: bool = False) -> None:
        """Queue a draw; served by the next farm-wide flush().

        ``auto_flush=True``: after queueing, the farm flushes itself once
        total pending work across all cores reaches ``auto_flush_rows``
        word rows (immediately when that threshold is None).  Words served
        by an auto-flush are parked in the per-service outboxes and
        returned by the tenant's next flush()/draw(), never dropped.
        """
        self._check_serving(core)
        self._svc(core).request(client, n_words)
        if auto_flush:
            if (self.auto_flush_rows is None
                    or self.pending_rows >= self.auto_flush_rows):
                self.flush(deliver=False)

    @property
    def pending_rows(self) -> int:
        """Unserved demand across all cores, in launch rows (words already
        coverable from client buffers contribute nothing)."""
        return sum(svc.rows_needed() for svc in self.services.values())

    def flush(self, max_wait_rows: Optional[int] = None,
              deliver: bool = True,
              slo_by_core: Optional[Dict[str, str]] = None,
              ) -> Dict[str, Dict[str, np.ndarray]]:
        """Serve every pending request: one batched launch per core GROUP.

        Cores are grouped by ``_compat_key``; each group with pending work
        costs one stacked-weight launch (``gang=False``: one launch per
        core).  Delivered words are bit-identical either way.

        ``max_wait_rows``: a group whose total needed rows is below it is
        *deferred* (no launch, its tenants keep waiting for a fuller
        gang), but never twice in a row.  ``deliver=False`` parks all
        served words in the per-service outboxes.  ``slo_by_core`` maps a
        core to the SLO class of its demand this flush: a group launches
        as ``"latency"`` if ANY member carries latency-class demand, as
        ``"bulk"`` only if EVERY member is bulk.

        Returns {core: {client: words}} for every client that received
        words (pending requests and previously parked outbox words alike).
        """
        if self.faults is not None:
            self.faults.on_flush()
        plans = {core: svc.prepare_rows()
                 for core, svc in self.services.items()
                 if core not in self._quarantined}
        groups: Dict[object, List[str]] = {}
        for core, (n_need, _) in plans.items():
            if n_need > 0:
                key = _compat_key(self.services[core]) if self.gang else None
                groups.setdefault(key if key is not None else ("solo", core),
                                  []).append(core)
        launching: List[Tuple[object, List[str]]] = []
        deferred_now: set = set()
        for key, cores in groups.items():
            total = sum(plans[c][0] for c in cores)
            overdue = any(c in self._deferred for c in cores)
            if max_wait_rows is None or total >= max_wait_rows or overdue:
                launching.append((key, cores))
            else:
                deferred_now.update(cores)
        out: Dict[str, Dict[str, np.ndarray]] = {}
        launching_cores = {c for _, cores in launching for c in cores}
        slo_by_core = slo_by_core or {}
        for key, cores in launching:
            classes = {slo_by_core.get(c) for c in cores}
            group_slo = ("latency" if "latency" in classes
                         else "bulk" if classes == {"bulk"} else None)
            if self.gang and len(cores) > 1:
                served = self._sched.launch(
                    key, [(c, self.services[c], plans[c][0], plans[c][1])
                          for c in cores], deliver=deliver, slo=group_slo)
                out.update(served)
            else:
                prof = self._sched.profile
                for c in cores:
                    svc = self.services[c]
                    if self.faults is not None:
                        self.faults.on_launch([c])
                    t0 = self.clock.now()
                    n_rows = _round_rows(plans[c][0], svc.config.t_block)
                    words, new_x = svc._launch(n_rows, plans[c][1])
                    t1 = self.clock.now()
                    served = svc.absorb(words, new_x, n_rows,
                                        deliver=deliver)
                    if prof is not None:
                        prof["launch"] += t1 - t0
                        prof["absorb"] += self.clock.now() - t1
                    if served:
                        out[c] = served
        # launch-free delivery pass for cores with nothing to launch;
        # deferred cores are skipped entirely
        for core, (n_need, _) in plans.items():
            if core in launching_cores or core in deferred_now:
                continue
            if n_need == 0:
                served = self.services[core].absorb(None, None, 0,
                                                    deliver=deliver)
                if served:
                    out[core] = served
        self._deferred = deferred_now
        if self._sched.profile is not None:
            self._sched.profile["flushes"] += 1.0
        return out

    def draw(self, core: str, client: str, n_words: int) -> np.ndarray:
        """Request + flush one client on one core; only that core's pool
        launches."""
        self._check_serving(core)
        return self._svc(core).draw(client, n_words)

    @property
    def launches(self) -> int:
        """Kernel launches issued: per-core launches + gang launches."""
        return (sum(svc.launches for svc in self.services.values())
                + self._sched.launches)

    @property
    def gang_launches(self) -> int:
        return self._sched.launches

    @property
    def dispatch_misses(self) -> int:
        """Distinct (group, rows, ragged) gang launch shapes so far."""
        return self._sched.dispatch_misses

    @property
    def plan_decisions(self) -> Dict[str, int]:
        """Executed planner decisions so far, by kind."""
        return dict(self._sched.decisions)

    @property
    def slo_forced(self) -> Dict[str, int]:
        """Planner decisions where an SLO class overrode the free choice."""
        return dict(self._sched.slo_forced)

    @property
    def profile_stats(self) -> Optional[Dict[str, float]]:
        """Accumulated per-stage flush seconds (``profile=True`` farms):
        plan / stack / launch / absorb, plus the flush count."""
        return (dict(self._sched.profile)
                if self._sched.profile is not None else None)

    # -- resumability -------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Farm-wide snapshot: every core pool, every client, in flight,
        with the deferral set, quarantine and rotations, and each core's
        device topology (``None`` for an unmeshed pool), so a restore onto
        another device count is caught."""
        return {"cores": {core: svc.snapshot()
                          for core, svc in self.services.items()},
                "gang_launches": self._sched.launches,
                "deferred": sorted(self._deferred),
                "quarantined": sorted(self._quarantined),
                "rotations": dict(self._rotations),
                "topology": {core: _topology(svc)
                             for core, svc in self.services.items()}}

    def restore(self, snap: Dict[str, object], *,
                on_topology_mismatch: str = "refuse") -> None:
        """Restore a snapshot() onto a farm with the SAME cores attached
        (extra or missing cores raise: a mixed restore point).

        A snapshot taken on another device topology (mesh axis, device
        count or device ids differ for any core) must not silently run over
        plans shaped for the old one: ``on_topology_mismatch="refuse"``
        (default) raises, ``"replan"`` drops every cached gang plan and
        planner decision and restores anyway.  Stream words do not depend
        on the device count, so a sharded snapshot continues bitwise on an
        unsharded farm and back."""
        if on_topology_mismatch not in ("refuse", "replan"):
            raise ValueError(
                f"on_topology_mismatch must be 'refuse' or 'replan', "
                f"got {on_topology_mismatch!r}")
        cores = snap["cores"]
        missing = set(cores) - set(self.services)
        extra = set(self.services) - set(cores)
        if missing or extra:
            raise ValueError(
                f"snapshot/farm core mismatch: snapshot-only {sorted(missing)}, "
                f"farm-only {sorted(extra)}")
        changed = sorted(core for core, topo
                         in dict(snap.get("topology") or {}).items()
                         if core in self.services
                         and _as_topo(topo) != _topology(self.services[core]))
        if changed:
            if on_topology_mismatch == "refuse":
                raise ValueError(
                    f"snapshot device topology differs from this farm's "
                    f"on cores {changed}; restore(snap, "
                    f"on_topology_mismatch='replan') to drop cached "
                    f"plans and re-plan on the current topology")
            self._sched._plans.clear()
            self._sched._decisions.clear()
        # rotations replay BEFORE the per-core restores: they re-point
        # routing slots at standbys, whose pools the snapshot then sets
        want = {c: int(n) for c, n in dict(snap.get("rotations", {})).items()}
        for core in sorted(set(want) | set(self._rotations)):
            n, have = want.get(core, 0), self._rotations.get(core, 0)
            if have > n:
                raise ValueError(
                    f"farm already rotated core {core!r} {have}x but the "
                    f"snapshot recorded {n}; cannot un-rotate")
            while self._rotations.get(core, 0) < n:
                self.rotate(core)
        self._quarantined = set(snap.get("quarantined", ()))
        for core, sub in cores.items():
            self.services[core].restore(sub)
        self._sched.launches = int(snap.get("gang_launches", 0))
        self._deferred = set(snap.get("deferred", ()))
