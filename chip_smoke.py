#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. Print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` into ``build/repro_torch_kernels``.
2. Hold each kernel against its plain PyTorch version on the card,
   bitwise (words, final state, trajectory), in f32 and bf16, on the
   committed chen (3-8-3) and hyperlorenz (4-16-4) weights, at a ragged
   lane count and with per-lane word offsets that wrap past 2**32; the
   lattice forms of K1 and K2 likewise against the plain dense loop at
   chen@ring32, chen@grid32 and chen@ring8 (8,192 + 37 lanes, 64 steps);
   the mxu forms of K1 and K2 (scalar cores and the lattices, with the
   coupling dot) likewise against the plain f32 FMA chains, on all five.
   The gang kernels K3 and K4 likewise, on the committed farm's cores
   (the four 3-8-3 cores as a gang of 4; hyperlorenz's farm and registry
   weights as a 4-16-4 gang of 2), padded and ragged: the words each
   lane block or core asked for, and the final states.  Their lattice
   forms likewise, on chen, chua, lorenz and rossler as lattices of the
   chen@ring32, chen@grid32 and chen@ring8 descriptors: K3 in 32 blocks
   of 256 lanes with ragged rows, K4 with 2,048 + 37 lanes a core and one
   core frozen early.  K3's mxu form likewise at every compiled mxu shape
   (the two scalar gangs; the four bases as lattices of chen@ring8,
   grid8, ring32 and grid32 with their one shared coupling operand), 32
   blocks of 128 lanes, padded and ragged.  Then the bf16 K1 on bf16x2
   (``bf16x2_bits_kernel``, ``bf16x2_lattice_bits_kernel``): its add, sub
   and mul.rn.bf16x2 against the f32 round trip, and its fused bias add
   and relu, on all 2**32 operand pairs each, and its tanh and sigmoid of
   two lanes against the round-trip kernels' on all 2**16 bf16 inputs;
   the f32 tanh and sigmoid results the two-lane bf16 mxu K1 reads
   (``div_fast``) against the ``__fdiv_rn`` form's on all 2**16 bf16
   inputs, the f32 mxu K1's tanh and sigmoid (``div_fast``) likewise on
   all 2**32 f32 inputs, and cvt.rn.bf16x2.f32 against ``__float2bfloat16_rn`` on all
   2**32 f32 inputs in each half (any mismatch fails); both bf16x2
   kernels, and the two-lane mxu K1 (``mxu_x2_bits_kernel``,
   ``bf16x2_mxu_bits_kernel``) in f32 and bf16, bitwise their plain
   versions at tiny and odd lane counts (1, 2, 3, 129, 257 lanes at 3-8
   and 4-16; 1, 3, 5 at chen@ring8 and ring32) with relu, tanh and
   sigmoid; the bf16 lattice K3 and K4 on the same row loop as the bf16x2
   lattice K1 (``bf16x2_lattice_gang_bits_kernel``,
   ``bf16x2_lattice_gang_stacked_kernel``) bitwise their plain versions at
   chen@ring8, grid8 and ring32 with relu, tanh and sigmoid (K3: six
   blocks of the four cores with 0, partial and full rows, ``s_block`` on
   the two-lane span and off it; K4: three cores at 1, 5 and 37 lanes, a
   0-row and a partial core); the bf16 lattice K2 on the bf16x2 step with
   staged 16-byte stores (``bf16x2_lattice_traj_kernel``) bitwise its
   plain version at chen@ring8, grid8, ring32 and grid32, odd lane counts
   (a ragged last CTA, lane-b halves partly live) with relu, tanh and
   sigmoid; the mxu K3 on the two-lane row loop
   (``mxu_x2_gang_bits_kernel``, ``bf16x2_mxu_gang_bits_kernel``) in f32
   and bf16 at 3-8, 4-16, chen@ring8 and ring32 with relu, tanh and
   sigmoid (six blocks with 0, partial and full rows, ``s_block`` on the
   two-lane span and off it); the scalar bf16 K2 on the bf16x2 step
   (``bf16x2_traj_kernel``) and the mxu K2 on two lanes a thread
   (``mxu_x2_traj_kernel``, ``bf16x2_mxu_traj_kernel``, f32 and bf16),
   both with staged 16-byte stores, bitwise their plain versions at odd
   lane counts (a ragged last CTA, lane-b halves partly live and, for a
   scalar core, steps whose values start mid-chunk) at 3-8, 4-16 and, for
   mxu, chen@ring8 and ring32, with relu, tanh and sigmoid; the scalar
   K3 and K4 on their K1's row loop, bf16 on bf16x2
   (``bf16x2_gang_bits_kernel``, ``bf16x2_gang_stacked_kernel``) and f32
   (``f32_gang_bits_kernel``, ``f32_gang_stacked_kernel``), bitwise
   their plain versions at 3-8 and 4-16 with relu, tanh and sigmoid (K3:
   six blocks with 0, partial and full rows at ``s_block`` 128, 256 and
   384; K4: three cores at 1, 5, 37 and 257 lanes, a 0-row and a partial
   core); their registers and spills; and, where ``cuobjdump`` is on PATH
   or beside nvcc, the SASS counts (the conversions F2F and F2FP, SHFL,
   REDUX, FFMA and the 16-byte stores among them) of the bf16x2 K1-K4
   forms, the bf16x2 lattice K2/K3/K4 and the two-lane mxu K1, K2 and K3
   beside the f32 K1, K3 and K4.
3. The main path, per dtype: ``PRNGService`` on chen with 512 clients x
   128 lanes (register, then three flushes), each client drawing 65,536
   words per flush (33.5 M words a flush).  Then the unfused path
   (``ops.chaotic_trajectory`` + ``ops.pack_words``) on the same first
   flush.  Each path has the launch counters zeroed just before it and
   read just after, and must have launched its one kernel and no other;
   the served words are checked against a standalone ``ChaoticPRNG``
   drawn in other chunks, a snapshot/restore continuation, and the
   unfused path.  Then the kernel times (CUDA events), the plain
   versions' times, and the bounds; K1 and K2 are held bitwise against
   their plain versions at the flush's own shape (65,536 lanes, from the
   pool's state before the first flush).
4. NIST monobit / runs / block frequency on 2**20 served words per dtype,
   under the JAX package's policy (``repro/prng/quality.py``): f32 words
   must pass outright; bf16 chen must not be quarantined by the offline
   gate (``repro_torch.prng.quality.nist_gate``).  The 2**20 served bf16 words are tested and printed, not
   gated: the reference's bf16 lanes coalesce onto shared orbits, so
   served bf16 words repeat across lanes (ROADMAP.md queue 3).
5. The farm path, per dtype: ``OscillatorFarm`` over the five committed
   farm cores (bf16: ``from_generated``; f32: the same solutions at
   ``dtype_bytes=4`` through ``add_core``), 128 clients x 128 lanes per
   core.  Three flushes, the launch counters zeroed just before each and
   read just after: F1 uniform (one stacked K4 launch, one K1 launch for
   hyperlorenz), F2 skewed (chen's clients draw 64x the others: ragged or
   split, never padded), F3 unequal pools (one more client on lorenz: the
   lane-concat K3).  Each flush's words are held bitwise against a
   ``gang=False`` farm, two chen clients against a standalone
   ``PRNGService``, and F2 against a snapshot taken with its requests
   pending, restored onto a fresh farm.  Then the gang kernels' times at
   F1's and F2's shapes, their plain versions' times and their bounds,
   and the ``gang=False`` cost of F1's 3-8-3 words (four K1 launches).
   In bf16 the K3 and K4 are the bf16x2 kernels on the K1's row loop;
   K3's ragged F2 is printed beside its chain floor (one thread's rows at
   the loop's SASS count, after the SASS phase).
5b. The serving tier.  (a) ``sweep_registry()``: the five registry systems
   in f32 and bf16 at the gate's recipe (30,000 words, 256 lanes, seed 0),
   each verdict printed with its p-values and ``quarantined_systems``, no
   f32 pair quarantined (the bf16 verdicts are printed, not gated), each
   pair's first 8,192 words bitwise the plain version's; the legacy
   ``draw_words`` (K2) bitwise plain.  (b) The committed farm under
   ``AsyncOscillatorFarm`` (offload on) with a ``HealthMonitor``, an
   ``AdmissionController``, a ``FlushJournal`` and a seeded ``FaultPlan``
   (transient launch failures; chen's monitor samples poisoned, chen with
   a standby): 128 clients a core, 32 tenant coroutines, rounds of one
   ``flush_now`` with 10 ms deadlines, until a round serves nothing (the
   online gate quarantines every bf16 core of this farm on its own
   coalescing lanes within about 40 rounds) or 64 rounds.  Every served
   word is held bitwise to a farm with no fault plan serving the same
   requests (quarantines and rotations mirrored after the same round);
   the monitor's launch failures must equal the plan's injections, no
   flush error, chen quarantined by its poisoned window and rotated once,
   any other quarantine backed by a failing window of its own words, a
   draw refused only on a core quarantined with no standby, K3 and K4
   launched by the front end's flushes (the counters read around its own
   ``register`` and ``flush_now`` calls alone); then ``replay_journal``
   onto a fresh farm must restore every position and its next flush must
   equal the served farm's.  Prints the flush wall (round 0, the
   rotation's, alone; then p50/p90/max, by cores serving, split by the
   farm's ``profile_stats``) beside the sync farm's, the deadline misses,
   the host's garbage collections and each kernel's launches.
6. The lattice path, per dtype: phase 3 on chen@ring32 (32 chen nodes on
   a ring, I = 96, vpu; derived from chen's committed weights), 512
   clients x 128 lanes, 16,384 words per client per flush (128 word
   rows), on an explicit vpu config, through the lattice forms of K1
   (served) and K2 (unfused), held against the plain dense loop at that
   shape too.
   NIST monobit / runs / block frequency on 2**20 served lattice words,
   printed and not gated (the JAX package makes no lattice quality
   claim).
7. The mxu path, per dtype: phase 6 with no config, the JAX package's
   default stream of chen@ring32 (its ``select_config`` picks the mxu
   unit), 4,096 words per client per flush (32 word rows), through the
   mxu forms of K1 (served) and K2 (unfused), held bitwise against one
   plain run at that flush's shape on its first 1,024 lanes; NIST
   printed, not gated.
8. The lattice farm path, per dtype: ``OscillatorFarm`` with
   chen/chua/lorenz/rossler@ring32 on ``default_config(96, 256, dtype,
   n_nodes=32)`` beside the scalar chen on its own vpu config, 128
   clients x 128 lanes a core (65,536 lanes a lattice gang).  Three
   flushes, the launch counters zeroed just before each and read just
   after: F1 uniform (16,384 words a client: one stacked lattice K4
   launch, one K1 for chen), F2 skewed (chen@ring32 at 16,384, the rest
   at 1,024: ragged or split), F3 unequal pools (one more lorenz@ring32
   client: the lane-concat lattice K3); no scalar gang kernel launches.
   Each flush bitwise against a ``gang=False`` farm, F2 against a
   snapshot taken with its requests pending and restored onto a fresh
   farm; F1's K4 and F3's K3 launches against one plain run each at
   their shapes; their times, bounds and the ``gang=False`` cost (in
   bf16 the K3 and K4 are the bf16x2 kernels, on the lattice K1's row
   loop).
9. The mxu farm path, per dtype: ``OscillatorFarm`` with the four
   ring32 cores of phase 8 added with NO config (the JAX farm's default
   lattice gang: ``select_config`` puts them on the mxu unit, s_block 128,
   t_block 256, unroll 8) beside chen, chua, lorenz and rossler 3-8-3 on
   ``select_config(3, 8, s_total=128, unit="mxu")``, 128 clients x 128
   lanes a core, 4,096 words a client.  Three flushes, the launch
   counters zeroed just before each and read just after: F1 uniform (one
   padded mxu K3 launch a group, no K4 of any form, no mxu K1), F2
   skewed (chen@ring32 and chen at 4,096, the rest at 256: ragged or
   split), F3 unequal pools (one more lorenz@ring32 client: padded
   lane-concat mxu K3).  Each flush bitwise against a ``gang=False`` farm
   (every core its own mxu K1), F2 against a restored snapshot; F3's
   lattice launch against one plain run on each core's first and last
   lane block; the mxu K3's times at F1 and F3, bounds, and the
   ``gang=False`` cost (four solo mxu K1 launches over F1's lanes).
10. The paper flow, for a tanh and a sigmoid net.  First the kernels'
   tanh and sigmoid alone (``chaotic_ann.activation``) against the plain
   formulas, bitwise, on every finite bf16 value and 2**24 f32 inputs.
   Then ``make_dataset("chen", 50_000)`` (RK-4 on the card; timed on the
   host's CPU too, and the two datasets compared) and, per
   activation: ``train`` on the card (3-8-3, 60 epochs, lr 3e-3, batch
   256; MSE, MAE, RMSE, R2 and seconds an epoch printed); ``select(3, 8,
   ...)`` min_latency and lowest_cost, each held to the JAX package's
   ``Candidate``; ``generate_core`` for both into a temporary directory
   and each ``testbench.py`` run on the card in its own process (a
   non-zero exit fails the phase).  The path, each part with the launch
   counters zeroed just before it and read just after: 2**20 words of
   ``ChaoticStream.from_trained`` (K1, f32; NIST subset printed, not
   gated), the trained net iterated 2,000 steps on the card (K2, f32;
   bounded), the min-latency core's ``generate`` and ``generate_bits``
   (K2, K1, bf16); each part's output is then held bitwise against the
   same call on the plain path (``backend="ref"``) on the card (the
   stream's first 2**16 words).  Then the
   tanh/sigmoid K1 and K2 bitwise against their
   plain versions at each core's ``s_block`` and at the served shape
   (65,536 lanes, 1,024 steps), timed there beside relu's K1 and the
   bounds.  tanh's test MSE must be below sigmoid's (Table II's order).
11. The farm of generated tanh and sigmoid cores.  Phase 10's chen nets
   and, trained here on the card per activation (60 epochs, lr 3e-3,
   batch 256; MSE and R2 printed), chua, lorenz and rossler 3-8-3 nets on
   one ``make_dataset(system, 8_000)`` a system.  First the tanh/sigmoid
   K3 (ragged rows) and K4 (a frozen core) against their plain versions,
   bitwise, in both dtypes, on those four nets and on two seeded 4-16-4
   nets, K4 also at F1's shape with unequal demands; each net's words
   must differ from relu's.  Then into a temporary directory:
   ``generate_farm`` (relu, every registered system, "pareto") and a
   ``generate_core`` for each trained net as ``<system>_<activation>`` on
   ``select(3, 8, "pareto")``, every ``Candidate`` held to the JAX
   package's.  Per dtype (bf16 ``from_generated``; f32 the same cores at
   ``dtype_bytes=4`` through ``add_core``): one gang group per
   activation and hyperlorenz alone; 128 clients x 128 lanes a core;
   three flushes as phase 5's, the launch counters zeroed just before
   each and read just after (F1 uniform: one K4 launch an activation and
   hyperlorenz's K1; F2 the chen cores skewed; F3 one more client on each
   lorenz core: one K3 launch an activation), each held against a
   ``gang=False`` farm; every gang launch of the flushes against the
   plain gang scan on each core's first and last lane block (lanes are
   independent) over its first 8 word rows, bitwise, and timed at its
   shape beside relu's launch of the same flush and its bound (in bf16
   the bf16x2 K3 and K4; F2's K3 also beside its chain floor).
12. Lattices of tanh and sigmoid nets: phase 10's chen nets and phase
   11's chua, lorenz and rossler nets expanded to 8-node rings (coupling
   0.05), chen's also to the 8-node torus; nothing is trained again.
   First the tanh/sigmoid lattice K1, K2, K3 (ragged rows) and K4
   (unequal demands) against their plain versions, bitwise, in both
   dtypes, at chen@ring8, grid8, ring32 and grid32; each kernel's words
   must differ from relu's.  Then, each part with the launch counters
   zeroed just before it and read just after: the no-config f32
   ``ChaoticStream.from_trained`` of the chen@ring8 lattice (its config
   held to the JAX package's vpu choice; lattice K1; 2**20 words, the
   first 2**16 bitwise against ``backend="ref"``; NIST printed, not
   gated), the lattice iterated on the card (lattice K2, f32), and
   ``generate_core`` for chen_ring8/chen_grid8 tanh and sigmoid on
   ``select(24, 64, "pareto", n_nodes=8)`` (held to the JAX package's),
   each ``testbench.py cuda`` in its own process, each core's
   ``generate`` (lattice K2) and ``generate_bits`` (lattice K1) bitwise
   against ``backend="ref"``.  Then a farm directory of ``generate_farm``
   for the four ring8 lattices (relu) beside ``<system>_ring8_tanh`` /
   ``_sigmoid``, served per dtype as phase 11's (128 clients x 128 lanes,
   F1 uniform: one lattice K4 an activation; F2 the chen cores hot; F3
   one more client on each lorenz core: one lattice K3 an activation),
   each flush bitwise against ``gang=False`` and every gang launch
   replayed against the plain gang scan on each core's first and last
   lane block over its first 8 word rows and timed beside relu's.  Last,
   lattice K1/K2 at chen@ring8,
   65,536 lanes x 256 steps, bitwise against plain and timed beside
   relu's, and timed at chen@ring32.
13. tanh and sigmoid in the mxu forms of K1-K3, on phases 10 and 11's
   nets (nothing trained again).  First the tanh/sigmoid mxu K1, K2 (the
   chen net or its expansion, a ragged lane count) and K3 (the four nets
   of an activation, phase 2's 32 blocks x 128 lanes and steps, padded
   and ragged) against their plain versions, bitwise, in both dtypes, at
   every MXU_SHAPES entry (3-8, 4-16 on two seeded nets, chen@ring8,
   grid8, ring32, grid32); each kernel's words must differ from relu's.
   Then, each part with the launch counters zeroed just before it and
   read just after: the no-config streams of chen's net expanded to
   chen@ring32 (f32 ``ChaoticStream.from_trained``, bf16 ``ChaoticPRNG``)
   and to chen@ring8 (bf16), each config held to the JAX package's mxu
   choice, 2**20 words through mxu K1, the first 2**11 bitwise against
   ``backend="ref"``, NIST printed and not gated; each lattice iterated
   through mxu K2 and held against ``backend="ref"``; chen_ring8 /
   chen_grid8 tanh and sigmoid cores on ``select(24, 64, "min_latency",
   n_nodes=8)`` (mxu bf16 p 5, held to the JAX package's), each
   ``testbench.py cuda`` in its own process, each core's ``generate``
   (mxu K2) and ``generate_bits`` (mxu K1) bitwise against
   ``backend="ref"``.  Then per dtype a farm of the four ring32 registry
   cores (relu) beside ``<system>@ring32_<activation>`` (the trained
   nets expanded), all with NO config: three mxu K3 groups, 128 clients
   x 128 lanes a core, 4,096 words a client; F1 uniform (one padded mxu
   K3 an activation, no K4 of any form), F2 the chen cores hot (the rest
   at 256 words), F3 one more client on each lorenz core; each flush
   bitwise against ``gang=False``, every gang launch against the plain
   gang scan on each core's first and last lane block over its first 2
   word rows, and timed.  Last, mxu K1/K2 with tanh and sigmoid at
   chen@ring32, 65,536 lanes x 64 steps, timed beside relu's, held
   bitwise against plain on the first 1,024 lanes.
14. Every shape the reference's kernels take (``src/repro/kernels/
   chaotic_ann.py`` pads any (I, H) and takes any lattice of whole 8-row
   sublanes; the card takes up to 1,024 nodes, phase 17 past 32).  The
   phase's shape libraries
   (``kernels/build.py``: 3-4 and 3-16 on both units, chen@ring16,
   chen@grid24, hyperlorenz@grid4 and hyperlorenz@ring6 on both) built
   first, in one
   parallel build, each library's seconds and registers printed.  (a) The
   paper's sweep across ANN sizes: chen 3-4-3 and 3-16-3 relu nets and a
   3-16-3 tanh net trained on the card on phase 10's dataset (20 epochs,
   from init seeds that keep the nets in the attractor box);
   ``select`` in the three user modes, held to the JAX package's; a
   ``generate_core`` for each net and mode and every testbench on the
   card, each of which must pass; the min-latency cores'
   ``generate`` (K2) and ``generate_bits`` (K1), an f32 stream (K1) and
   the net iterated from test inputs (K2), and for the 3-16
   relu net an mxu stream and trajectory (mxu K1, K2) in both dtypes, each
   beside the plain path; then per net and dtype a farm of its three
   cores (two gang: K4 at F1, K3 at F3; one alone, K1), the 3-16 relu net
   also as two mxu cores (mxu K3), each flush bitwise a ``gang=False``
   farm.  (b) ``PRNGService`` on chen@ring16, chen@grid24,
   hyperlorenz@grid4 and hyperlorenz@ring6 (6 nodes in slots of 8
   threads, four slots a warp), 16 clients x 1,024 lanes, per dtype on a
   vpu config
   (lattice K1, and K2 unfused on the same flush) and with no config (the
   JAX choice: mxu K1; the vpu at f32 grid4), two clients bitwise one
   plain K1 run; each lattice iterated on the mxu unit (mxu K2).  (c) A
   farm of chen, chua, lorenz and rossler @grid24 on a vpu config (lattice
   K4 at F1, K3 at F3) beside the same four with no config (mxu K3), 8
   clients x 128 lanes a core, each flush bitwise ``gang=False``.  Each
   part with the launch counters zeroed just before it and read just
   after, its launches attributed to its (shape, dtype).  Then every
   (kernel, shape, dtype) the parts launched against its plain version
   at a cut of lanes and rows, bitwise (words each lane asked for, final
   states), timed beside the plain time and the bound (a row of the
   ``kernels`` line with a ``shape`` field); every kernel form in both
   dtypes must have launched on a shape outside the default library, at
   24 nodes, at 6 and on the 4-D base.  Last, W's cost: the lattice K1 at
   chen@grid24 (24 of a slot's 32 threads working) beside chen@grid32 at
   the same lanes and steps, each over its ops bound.
15. The farm across devices (``repro_torch.distributed.sharding``): meshes
   of cuda:0 listed 1, 2 and 4 times (one card cut into k shards, each
   shard a launch of its own) and every visible card when there are
   several, printed.  Per dtype: ``GangCostModel.fit`` of the committed
   farm's 3-8-3 candidate on the card, its device fee on the 4-entry
   mesh, each term printed in seconds beside the default's; the committed
   farm at F1-F3 (as phase 5) unsharded, on every mesh, and under the
   fitted model unsharded and on 4 shards, each meshed flush with the
   launch counters zeroed just before and read just after, its decision,
   launches, shards by mesh entry and device-to-device bytes printed, its
   words bitwise the unsharded flush's (F1: a K4 and a K1 launch a shard;
   F3: a K3 launch a shard); in f32 a snapshot of the 4-shard farm with
   requests pending, refused by an unsharded farm and restored there with
   ``on_topology_mismatch="replan"``, its next flush bitwise; the served
   chen at 512 clients x 128 lanes on 2 and 4 shards, 16,384 words a
   client a flush (a K1 launch a shard, bitwise the unsharded service);
   the chen@ring32 lattice farm (vpu: lattice K4 at F1, K3 at F3) and the
   mxu farm (mxu K3) at F1 and F3 on 2 shards, bitwise unsharded.  The
   phase's launches per kernel and dtype go into the ``kernels`` rows as
   ``sharded_launches``.
16. The LM stack (``repro_torch.models``, ``serve/engine.py``, the train
   step, data pipeline, compression, checkpoint-free loop and launcher),
   random weights from a seeded generator on the card.  (a) llama3_2_3b
   at full width and depth (28 layers, bf16): ``prefill`` of 4 prompts of
   64 tokens, its last logits held against ``forward(last_only=True)``
   (LM_LAST_TOL of their largest magnitude), then 32 decode steps, and
   the generation repeated by ``greedy_generate``: the same tokens; prefill
   tokens/s, decode ms a step and peak memory printed.  (b) The same
   width at 2 layers in f32 (TF32 off): one parameter set on the CPU and
   on the card, the logits of the same tokens within LM_CPU_TOL of their
   largest magnitude.  (c) qwen3_moe_30b_a3b at full width, 2 of its 48
   layers, served as (a), prefill's ``dropped_frac`` printed, every
   decode step's 0.  (d) llama3_2_3b at full width, 4 layers, bf16,
   remat, trained 4 steps through the launcher's ``train`` (``loop.run``;
   batch 8 x 512 tokens, 2 microbatches, warmup-cosine AdamW, int8
   gradient compression with error feedback, the chaotic shuffle), the
   launch counters zeroed just before and read just after: the shuffle
   must have launched K1 (``lm_launches`` in the ``kernels`` row of
   ``chaotic_ann_bits/f32``) and no other kernel; each step's loss and
   grad norm finite; step ms, tokens/s, peak memory and model TFLOP/s
   (6 x active params x tokens / s) beside the card's bf16 dense peak.
17. Lattices of more than 32 nodes (a lane slot of W = slot_width(N)
   threads spanning W / 32 warps; neighbours and the fold through shared
   memory).  The phase's ten shape libraries (the lattice and mxu families
   at chen@ring40, chen@grid64, hyperlorenz@ring34, chen@ring128 and
   chen@ring1024) are built in one parallel build started before phase 2,
   beside the earlier phases; the phase waits for it, then prints each
   library's seconds and its kernels' registers and spills.  (a)
   ``PRNGService`` on chen@ring40, chen@grid64, hyperlorenz@ring34 and
   chen@ring128 from the committed registry weights (``default_params``,
   full width), 16 clients x 1,024 lanes, per dtype on a vpu config
   (lattice K1; lattice K2 unfused on the same flush) and with no config
   (the JAX choice: mxu K1), two clients bitwise one plain K1 run; each
   lattice iterated on the mxu unit (mxu K2).  (b) A farm of chen, chua,
   lorenz and rossler @ring40 on a vpu config (lattice K4 at F1, K3 at
   F3) beside the same four with no config (mxu K3), 8 clients x 128
   lanes a core, each flush bitwise ``gang=False``; the mxu group's
   s_block and share of mirrored lane halves printed.  (c) Phase 10's
   tanh and sigmoid chen nets expanded to ring40: vpu K1 and mxu K1 in
   both dtypes.  (d) chen@ring1024 at the kernel level (the reference's
   DSE has no candidate there): vpu K1 and mxu K1 in both dtypes.  (e)
   Lattice K3, K4 and mxu K3 at grid64, hyperlorenz@ring34 and ring128 at
   the kernel level.  Each part with the launch counters zeroed just
   before and read just after.  Then every (kernel, shape, dtype)
   launched against its plain version at a cut of lanes and rows (64
   lanes x 2 steps at 1,024 nodes), bitwise, timed beside the plain time
   and the bound (a ``kernels`` row with ``shape``, ``slot_width`` and
   path "wide"); every lattice form (vpu K1-K4, mxu K1-K3) in both dtypes
   must have launched at 40, 64, 128 and 34 nodes, vpu and mxu K1 at
   1,024 and with tanh and sigmoid at 40.  Last, the exchange's cost: the
   lattice K1 at chen@grid64 beside chen@grid32 (one warp, shuffles) at
   the same lanes and steps and at twice the lanes (grid64's threads),
   per node-step, each over its ops bound.

Prints the ``kernels`` JSON line, then as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
no CUDA card is visible.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time
import zlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM rates outside the tensor cores (132 SMs at the 1.98 GHz boost
# clock), and HBM bandwidth (NVIDIA data sheet).  Every op of a step
# rounds in the state dtype, which tensor cores (f32 accumulators) do not
# do.  A vpu op cannot fuse (the reference rounds every multiply and add
# on its own; the build has --fmad=false), so it is one instruction: 128
# FMUL or FADD a clock per SM in f32, 256 bf16 results a clock per SM in
# packed bf16x2 add or multiply.  The mxu chains are fused multiply-adds:
# the data sheet's 67 TFLOP/s f32 rate, two flops an FMA; their separate
# adds and the activations' formulas go at the f32 instruction rate.
H100_SMS, H100_BOOST_HZ = 132, 1.98e9
PEAK_OPS = {"f32": 128 * H100_SMS * H100_BOOST_HZ,     # 33.5e12 ops/s
            "bf16": 256 * H100_SMS * H100_BOOST_HZ,    # 66.9e12 ops/s
            "mxu": 67e12}                              # flops/s
PEAK_HBM_BYTES = 3.35e12
# a device spin of about 25 ms at the H100's 1.98 GHz boost clock, long
# enough for the host to queue a timed loop's calls behind it
QUEUE_SPIN_CYCLES = 50_000_000

CHECK_LANES = 65_536 + 37      # ragged: not a multiple of the block size
CHECK_STEPS = 512
LATTICE_CHECK_LANES = 8_192 + 37
LATTICE_CHECK_STEPS = 64
# kernel-vs-plain checks: (system, lanes, steps); the plain lattice loop
# is dense over I = 96, H = 256, so its checks are smaller
CHECKS = (("chen", CHECK_LANES, CHECK_STEPS),
          ("hyperlorenz", CHECK_LANES, CHECK_STEPS),
          ("chen@ring32", LATTICE_CHECK_LANES, LATTICE_CHECK_STEPS),
          ("chen@grid32", LATTICE_CHECK_LANES, LATTICE_CHECK_STEPS),
          ("chen@ring8", LATTICE_CHECK_LANES, LATTICE_CHECK_STEPS))
# the bf16 K1 on bf16x2 (bf16x2_bits_kernel, bf16x2_lattice_bits_kernel)
# at tiny and odd lane counts, every activation: one plain run on the most
# lanes, each count held to its first lanes (lanes are independent)
BF16X2_CHECKS = (("chen", (1, 2, 3, 129, 257), 64),
                 ("hyperlorenz", (1, 2, 3, 129, 257), 64),
                 ("chen@ring8", (1, 3, 5), 16),
                 ("chen@ring32", (1, 3, 5), 16))
# the bf16 lattice K3 and K4 on the bf16x2 row loop
# (bf16x2_lattice_gang_bits_kernel, bf16x2_lattice_gang_stacked_kernel),
# every activation, words and state bitwise one plain run each: K3 at
# each (system, s_blocks, steps) entry's s_blocks, one on the two-lane
# span 2 * 128 / n_nodes and two odd multiples of 128 / n_nodes (a
# block's last CTA then holds one live half), six blocks of the four
# cores with 0, partial and full rows; K4 on three cores with a 0-row and
# a partial core at odd lane counts, each count held to the plain run's
# first lanes of every core
LATTICE_GANG_X2_CHECKS = (("chen@ring8", (16, 32, 48), 16),
                          ("chen@grid8", (16, 32, 48), 16),
                          ("chen@ring32", (4, 8, 12), 8))
LATTICE_GANG_X2_CORE_MAP = [2, 0, 3, 1, 1, 2]
LATTICE_GANG_X2_K3_ROWS = [0, 3, 99, 1, 99, 5]   # clamped to steps // 2
LATTICE_GANG_X2_LANES = (1, 5, 37)
LATTICE_GANG_X2_K4_ROWS = [99, 0, 3]
# the scalar K3 and K4, bf16 on the bf16x2 row loop (bf16x2_gang_bits_kernel,
# bf16x2_gang_stacked_kernel) and f32 on the f32 row loop
# (f32_gang_bits_kernel, f32_gang_stacked_kernel) at 3-8 and 4-16, every
# activation, words and
# state bitwise one plain run each: K3 six blocks of the gang's cores (the
# LATTICE_GANG_X2 core map modulo the cores) with 0, partial and full rows
# at each (shape, s_blocks, steps) entry's s_blocks (a K3 CTA spans 128
# lanes: 128 is the served farms' s_block, 384 three CTAs a block), each
# s_block's blocks held to the first lanes of the plain run's at the
# largest; K4 on three cores (4-16: its two, the first again) with a 0-row
# and a partial core at GANG_X2_LANES lanes a core (a lone lane-a half, a
# ragged CTA), each count held to the plain run's first lanes of every
# core
GANG_X2_CHECKS = (("3-8", (128, 256, 384), 16),
                  ("4-16", (128, 256, 384), 16))
GANG_X2_LANES = (1, 5, 37, 257)
# the bf16 lattice K2 on the bf16x2 step (bf16x2_lattice_traj_kernel) at
# odd lane counts, every activation: a CTA holds 2 * 128 / n_nodes lanes
# (32 at 8 nodes, 8 at 32), so these take a lone lane-a half, lane-b halves
# partly live and a ragged last CTA; the trajectory bitwise one plain run
# on the most lanes, each count held to its first lanes
LATTICE_TRAJ_X2_CHECKS = (("chen@ring8", (1, 3, 17, 37, 65), 16),
                          ("chen@grid8", (1, 3, 17, 37, 65), 16),
                          ("chen@ring32", (1, 3, 5, 13), 8),
                          ("chen@grid32", (1, 5, 13), 8))
# the scalar bf16 K2 on the bf16x2 step (bf16x2_traj_kernel) and the mxu K2
# on two lanes a thread (mxu_x2_traj_kernel, bf16x2_mxu_traj_kernel; f32
# and bf16) at odd lane counts, every activation: a scalar core's CTA holds
# 256 lanes, so these take a lone lane-a half, lane-b halves partly live,
# a ragged last CTA and (but in f32 at 4-16) steps whose values start
# mid-chunk; the trajectory bitwise one plain run on the most lanes, each
# count held to its first lanes; fewer mxu steps: the plain f32 FMA chains
# are thousands of small ops a step at 32 nodes
TRAJ_X2_CHECKS = (("chen", (1, 2, 3, 37, 129, 257), 64),
                  ("hyperlorenz", (1, 2, 3, 37, 129, 257), 64))
MXU_TRAJ_X2_CHECKS = (("chen", (1, 2, 3, 37, 129, 257), 32),
                      ("hyperlorenz", (1, 2, 3, 37, 129, 257), 32),
                      ("chen@ring8", (1, 3, 17, 37), 8),
                      ("chen@ring32", (1, 3, 5), 4))
# the mxu K3 on the two-lane row loop (mxu_x2_gang_bits_kernel,
# bf16x2_mxu_gang_bits_kernel), f32 and bf16, every activation: (shape,
# s_blocks, steps, cores), six blocks of the first `cores` nets (the
# LATTICE_GANG_X2 core map modulo the cores) with 0, partial and full rows,
# s_block on the two-lane span 2 * 128 / n_nodes and off it (an odd
# multiple of 128 / n_nodes: a block's last CTA then holds one live half;
# a scalar core's 128); words and state bitwise one plain run at the
# largest s_block, each smaller s_block's blocks held to the first lanes
# of the plain run's (lanes are independent); two ring32 cores and four
# steps: the plain f32 chains are thousands of small ops a core a step
MXU_GANG_X2_CHECKS = (("3-8", (128, 256, 384), 16, 4),
                      ("4-16", (128, 256), 8, 2),
                      ("chen@ring8", (16, 32, 48), 8, 4),
                      ("chen@ring32", (4, 8, 12), 4, 2))
# the two-lane mxu K1 (mxu_x2_bits_kernel, bf16x2_mxu_bits_kernel) at the
# same lane counts, f32 and bf16, every activation; the plain f32 FMA
# chains are thousands of small ops a step at 32 nodes, so fewer steps
MXU_X2_CHECKS = (("chen", (1, 2, 3, 129, 257), 32),
                 ("hyperlorenz", (1, 2, 3, 129, 257), 32),
                 ("chen@ring8", (1, 3, 5), 8),
                 ("chen@ring32", (1, 3, 5), 4))
# the kernels whose SASS is counted (name, template arguments): the bf16x2
# K1, K2, K3 and K4 forms (relu; tanh at 3-8; K3 sigmoid too, for its F2
# chain floor), the f32 K3 (each activation, for its F2 chain floor) and K4,
# and the bf16x2 lattice K2, K3 and K4
# (relu at chen@ring32, K2 tanh and sigmoid and K4 tanh at ring8) beside
# the f32 K1; the two-lane mxu K1 at chen@ring32 (relu, tanh, sigmoid in
# bf16; relu and tanh in f32; relu at 3-8) beside the two-lane mxu K2
# (relu in both dtypes, tanh and sigmoid in bf16 at chen@ring32; relu in
# f32 at 3-8, whose steps may start mid-chunk) and K3 (relu in both
# dtypes; tanh and sigmoid in bf16), and the f32 K1 with tanh and
# sigmoid, scalar at 3-8 and lattice at chen@ring8.  The round trip's
# conversion is F2F.BF16.F32 (F2F.BF16 counts it), the bf16x2 pack F2FP;
# F2F.F64 counts conversions to and from f64, DMUL f64 multiplies, F2I
# float-to-integer conversions, FRND a float rounded to an integer (exp's
# floor; its f64 scaling had the rest; SASS_FREE checks the loops that
# must have none), MUFU the reciprocal's approximation;
# FCHK guards an IEEE divide's slow path; STG.128 counts 16-byte stores.
# Each is counted whole and in its row loop; the two-lane mxu loops are
# not unrolled, so a mxu K1/K3 loop is two steps, a mxu K2 loop one
SASS_KERNELS = (("bf16x2_bits_kernel", (3, 8, 0)),
                ("bf16x2_bits_kernel", (3, 8, 1)),
                ("bits_kernel", ("f", 3, 8, 0)),
                ("bits_kernel", ("f", 3, 8, 1)),
                ("bits_kernel", ("f", 3, 8, 2)),
                ("bf16x2_traj_kernel", (3, 8, 0)),
                ("bf16x2_traj_kernel", (3, 8, 1)),
                ("bf16x2_gang_bits_kernel", (3, 8, 0)),
                ("bf16x2_gang_bits_kernel", (3, 8, 1)),
                ("bf16x2_gang_bits_kernel", (3, 8, 2)),
                ("bf16x2_gang_stacked_kernel", (3, 8, 0)),
                ("bf16x2_gang_stacked_kernel", (3, 8, 1)),
                ("f32_gang_bits_kernel", (3, 8, 0)),
                ("f32_gang_bits_kernel", (3, 8, 1)),
                ("f32_gang_bits_kernel", (3, 8, 2)),
                ("f32_gang_stacked_kernel", (3, 8, 0)),
                ("bf16x2_lattice_bits_kernel", (3, 8, 32, 0, 0)),
                ("bf16x2_lattice_gang_bits_kernel", (3, 8, 32, 0, 0)),
                ("bf16x2_lattice_gang_stacked_kernel", (3, 8, 32, 0, 0)),
                ("bf16x2_lattice_gang_stacked_kernel", (3, 8, 8, 0, 1)),
                ("lattice_bits_kernel", ("f", 3, 8, 32, 0, 0)),
                ("lattice_bits_kernel", ("f", 3, 8, 8, 0, 1)),
                ("lattice_bits_kernel", ("f", 3, 8, 8, 0, 2)),
                ("bf16x2_lattice_traj_kernel", (3, 8, 32, 0, 0)),
                ("bf16x2_lattice_traj_kernel", (3, 8, 8, 0, 1)),
                ("bf16x2_lattice_traj_kernel", (3, 8, 8, 0, 2)),
                ("bf16x2_mxu_bits_kernel", (3, 8, 32, 0, 0)),
                ("bf16x2_mxu_bits_kernel", (3, 8, 32, 0, 1)),
                ("bf16x2_mxu_bits_kernel", (3, 8, 32, 0, 2)),
                ("bf16x2_mxu_bits_kernel", (3, 8, 1, 0, 0)),
                ("mxu_x2_bits_kernel", (3, 8, 32, 0, 0)),
                ("mxu_x2_bits_kernel", (3, 8, 32, 0, 1)),
                ("mxu_x2_bits_kernel", (3, 8, 1, 0, 0)),
                ("bf16x2_mxu_traj_kernel", (3, 8, 32, 0, 0)),
                ("bf16x2_mxu_traj_kernel", (3, 8, 32, 0, 1)),
                ("bf16x2_mxu_traj_kernel", (3, 8, 32, 0, 2)),
                ("mxu_x2_traj_kernel", (3, 8, 32, 0, 0)),
                ("mxu_x2_traj_kernel", (3, 8, 1, 0, 0)),
                ("bf16x2_mxu_gang_bits_kernel", (3, 8, 32, 0, 0)),
                ("bf16x2_mxu_gang_bits_kernel", (3, 8, 32, 0, 1)),
                ("bf16x2_mxu_gang_bits_kernel", (3, 8, 32, 0, 2)),
                ("mxu_x2_gang_bits_kernel", (3, 8, 32, 0, 0)))
SASS_OPS = ("F2F", "F2F.BF16", "F2F.F64", "F2I", "FRND", "DMUL", "F2FP",
            "HADD2", "HMUL2", "HFMA2", "FADD", "FMUL", "FFMA", "MUFU", "FCHK",
            "LDS", "SHFL", "REDUX", "STS", "STG", "STG.128")
# the SASS_OPS each row loop must not hold: the f32 K1's tanh and sigmoid
# divide by div_fast and scale exp's result in f32 bits, so neither an
# IEEE divide's check nor a conversion is left (sigmoid's floor stays
# FRND, measured faster than its integer-add form: PERF.md); no sigmoid
# loop converts to or from f64
F32_K1_FREE = {1: ("F2F", "F2I", "FRND", "DMUL", "FCHK"),
               2: ("F2F", "F2I", "DMUL", "FCHK")}
SASS_FREE = {(name, ("f", 3, 8) + lat + (a,)): ops
             for name, lat in (("bits_kernel", ()),
                               ("lattice_bits_kernel", (8, 0)))
             for a, ops in F32_K1_FREE.items()}
N_CLIENTS = 512
LANES_PER_CLIENT = 128
WORDS_PER_CLIENT = 65_536
NIST_WORDS = 1 << 20
# the served-word checks' alpha (repro/prng/quality.py's GATE_ALPHA)
NIST_ALPHA = 0.01
# the serving tier: the offline sweep at the gate's recipe (30,000 words
# from 256 fresh lanes, seed 0; repro/prng/quality.py), each pair's words
# held bitwise to the plain version on the first GATE_CUT_ROWS rows
GATE_STREAMS, GATE_CUT_ROWS = 256, 32
# the async front-end over the committed farm: 128 clients a core spread
# over SERVE_TENANTS tenant coroutines, one flush a round, a client's
# words a round by the round's shape (U uniform, S skewed: SERVE_HOT's
# clients hot); from round SERVE_EXTRA_ROUND one more lorenz client makes
# the pools unequal (K3's lane-concat layout), as the farm phase's F3
SERVE_CLIENTS, SERVE_TENANTS = 128, 32
# at most this many rounds: the committed farm's bf16 lanes coalesce, and
# the online gate has quarantined every core within about 40 rounds
# (PERF.md section 7); the phase stops at the first round that serves
# nothing
SERVE_ROUNDS = "US" * 32
SERVE_PRINT_EVERY = 8                    # a round's line, and every change
SERVE_WORDS = {"U": 1_024, "S": 256}
SERVE_HOT, SERVE_HOT_WORDS = "chua", 4_096
SERVE_EXTRA_ROUND = 3
SERVE_POISON = "chen"                    # poisoned samples, has a standby
SERVE_FAULTS = dict(seed=3, transient_rate=0.2, max_transients=4)
SERVE_HEALTH = dict(breaker_threshold=5, backoff_base_ms=1.0, seed=0)
# the async demo's deadline (examples/async_demo.py); flush_now follows
# the submissions at once, so a miss is how far the flush ran past it
SERVE_DEADLINE_MS = 10.0
DRAW_WORDS = (65_536, 256, 16)           # draw_words: words, lanes, burn-in

FARM_DIR = ROOT / "results" / "generated_cores" / "farm"
# the committed farm's gangs: its four 3-8-3 cores, and hyperlorenz's farm
# and registry weights as a 4-16-4 pair
GANGS = {"3-8": ("chen", "chua", "lorenz", "rossler"),
         "4-16": ("hyperlorenz", "registry:hyperlorenz")}
GANG_BLOCKS, GANG_S_BLOCK = 512, 128     # K3 check: 65,536 lanes
STACK_LANES = 16_384 + 37                # K4 check: lanes per core
# the farm solutions' schedule (t_block 256, unroll 8: row granularity 8)
FARM_T_BLOCK, FARM_UNROLL = 256, 8
# K3 demands: 0, not multiples of 8, above the launch's rows; K4: a zero
K3_ROW_MAP = np.resize([0, 3, 300, 17, 128, 9, 256, 64], GANG_BLOCKS)
K4_ROW_MAP = [0, 13, 300, 100]
FARM_CLIENTS = 128
FARM_WORDS = 16_384                      # per client: 128 word rows
HOT_WORDS, COLD_WORDS = 65_536, 1_024    # F2: chen's clients, the others
# the served lattice: on an explicit vpu config, and with no config (the
# JAX package's default stream, mxu)
LATTICE = "chen@ring32"
LATTICE_WORDS = 16_384                   # per client: 128 word rows
MXU_WORDS = 4_096                        # per client: 32 word rows
# the lattice gang kernels' checks: the four 3-8 bases as lattices of each
# descriptor; K3 in 32 blocks of 256 lanes (ragged rows), K4 with lanes a
# core not a multiple of a CTA's and one core frozen early
LATTICE_GANG_CHECKS = ("chen@ring32", "chen@grid32", "chen@ring8")
LATTICE_GANG_BLOCKS, LATTICE_GANG_S_BLOCK = 32, 256
LATTICE_K3_ROW_MAP = np.resize([0, 3, 40, 17, 32, 9, 1, 8], 32)
LATTICE_STACK_LANES = 2_048 + 37
LATTICE_K4_ROW_MAP = [32, 5, 32, 32]
# the lattice farm: the four bases at chen@ring32's descriptor beside the
# scalar chen, 128 clients x 128 lanes a core (65,536 lanes a lattice gang)
LATTICE_FARM = ("chen@ring32", "chua@ring32", "lorenz@ring32",
                "rossler@ring32")
# K3's mxu form, checked at every MXU_SHAPES entry: the scalar gangs, and
# the four 3-8 bases as lattices of each compiled descriptor; 32 blocks of
# 128 lanes (a CTA's worth for a scalar core), LATTICE_K3_ROW_MAP's ragged
# rows; the plain f32 FMA chains of a lattice are bound by op launches
# (4 cores x 112 chains a step at 8 nodes, x 448 at 32), so those checks
# run fewer steps (the farm phase checks 64 steps at 32 nodes); phase 13
# runs them again with tanh and sigmoid (since then 32 / 8 / 6 steps at 1
# / 8 / 32 nodes, from 64 / 32 / 8: the run's time; 6 steps keep partial
# rows, t_block 8 leaving row granularity 1 there)
MXU_GANG_CHECKS = ("3-8", "4-16", "chen@ring8", "chen@grid8", "chen@ring32",
                   "chen@grid32")
MXU_GANG_BLOCKS, MXU_GANG_S_BLOCK = 32, 128
MXU_GANG_STEPS = {1: 32, 8: 8, 32: 6}            # by n_nodes
MXU_GANG_T_BLOCK, MXU_GANG_UNROLL = 8, 2         # row granularity 2
# the mxu farm: the four ring32 cores with NO config (the JAX farm's
# default lattice gang, mxu) beside the four 3-8-3 registry nets on the
# mxu unit; F2's cold cores draw MXU_COLD_WORDS
MXU_COLD_WORDS = 256
# phase 10, the paper flow: the quickstart's chen dataset, trained 60
# epochs (the quickstart trains 200; 60 is the JAX activation-ordering
# test's recipe) with tanh and with sigmoid; the two solutions the JAX
# package's DSE selects for a 3-8-3 net (a CPU run of repro.core.dse.select,
# held in tests/test_torch_paper_flow.py too); 2**20 words a stream; the
# kernels checked and timed at the served shape (phase 3's 65,536 lanes,
# 1,024 steps) and at each generated core's s_block
PAPER_ACTIVATIONS = ("tanh", "sigmoid")
PAPER_SAMPLES = 50_000
PAPER_EPOCHS = 60
PAPER_SELECT = {
    "min_latency": dict(i_dim=3, h_dim=8, p=5, compute_unit="vpu",
                        dtype_bytes=2, unroll=8, t_block=256, n_nodes=1),
    "lowest_cost": dict(i_dim=3, h_dim=8, p=0, compute_unit="vpu",
                        dtype_bytes=2, unroll=1, t_block=32, n_nodes=1)}
PAPER_CHECK_LANES, PAPER_CHECK_STEPS = 65_536, 1_024
# the plain checks' depths (each core's generate / generate_bits and its
# K1/K2 at the core's s_block; the stream's first words) are the plain
# loops' launches, cut to pay for phase 15's time
PAPER_CORE_STEPS = 256
# the stream's words held bitwise against the plain path: its first 256
# word rows (the plain loop's launches, not its lanes, set its time)
PAPER_STREAM_CHECK_WORDS = 1 << 16
ATTRACTOR_LANES, ATTRACTOR_STEPS = 16, 2_000
ACT_F32_INPUTS = 1 << 24
# ops per hidden unit that tanh and sigmoid add to a step (relu's select
# is not counted in step_flops), each one instruction at the f32 vpu rate,
# a fused multiply-add too:
# tanh: clamp 2, x^2 1, 9 FMAs, x * P 1, divide 1, |x| < 0.0004 1, select 1;
# sigmoid: negate 1, exp (clamp 2, 1 + 2 + 5 + 1 FMAs, floor 1, r^2 1,
# + 1 1, the scaling by 2^fx 2: an add to the exponent field and its
# range compare (the kernels scale in f32 bits; an f64 product, 2^fx
# built from its bits, counted the same 2), flush 1), 1 + e 1, divide 1,
# flush 1.
# These are f32 ops in both state dtypes (bf16 takes the f32 formula).
ACT_OPS = {"relu": 0, "tanh": 16, "sigmoid": 21}
# phase 11, a farm of generated tanh and sigmoid cores: ``generate_farm``'s
# relu cores (every registered system) beside a tanh and a sigmoid core of
# each 3-8-3 system; chen's nets are phase 10's, the others are trained
# here per activation (PAPER_EPOCHS, lr 3e-3, batch 256) on one dataset a
# system, cut to 8,000 samples from the quickstart's 50,000 (the run's
# time: RK-4 on the card is dispatch-bound, about 0.65 ms a sample)
GEN_SYSTEMS = ("chen", "chua", "lorenz", "rossler")
GEN_SAMPLES = 8_000
# repro.core.dse.select(i, h, "pareto") for each registered shape (a CPU
# run of the JAX package); from_generated clamps p to a client's 128 lanes
GEN_SELECT = {(3, 8): dict(i_dim=3, h_dim=8, p=3, compute_unit="vpu",
                           dtype_bytes=2, unroll=8, t_block=256, n_nodes=1),
              (4, 16): dict(i_dim=4, h_dim=16, p=3, compute_unit="vpu",
                            dtype_bytes=2, unroll=8, t_block=256, n_nodes=1)}
# F2 skews the chen cores (HOT_WORDS a client, the rest COLD_WORDS); F3
# adds one client to each lorenz core
GEN_HOT, GEN_F3 = "chen", "lorenz"
# tanh/sigmoid K3/K4 checks beside the farm: the four trained 3-8-3 nets
# and two seeded 4-16-4 nets, K3 in 64 blocks of 128 lanes with ragged
# rows, K4 with a ragged lane count and a frozen core; K4 also at F1's
# shape (4 x 16,384 lanes) with unequal demands
# (64 rows, cut to pay for phase 15's time: the row map below still gives
# blocks of 0, partial and all rows)
GEN_CHECK_BLOCKS, GEN_CHECK_STEPS = 64, 128
GEN_K3_ROW_MAP = np.resize([0, 3, 128, 17, 64, 9, 200, 1], GEN_CHECK_BLOCKS)
GEN_STACK_LANES = 4_096 + 37
GEN_K4_ROW_MAP = [0, 13, 200, 64]
GEN_F1_ROW_MAP = [128, 8, 77, 0]
# the farms' gang launches (phases 11 and 12) replayed on each core's first
# and last lane block over their first word rows: a plain gang scan's time
# is its launches, a few per op of each step, whatever its lanes (8 rows:
# all of F2's cold cores' demand; cut to pay for phase 15's time)
GEN_REPLAY_ROWS = 8
# phase 12, lattices of tanh and sigmoid nets: phase 10's chen nets and
# phase 11's chua, lorenz and rossler nets expanded to 8-node rings
# (coupling 0.05), chen's also to the 8-node torus.  The lattice K1-K4
# checks run at every LATTICE_SHAPES entry on expansions of the four nets
# of an activation (K1/K2 on chen's), with the lattice gang checks'
# blocks, lanes and demands; the plain dense loop at 32 nodes is 4x the
# ops of 8, so those run fewer steps
LAT_ACT_SHAPES = ("chen@ring8", "chen@grid8", "chen@ring32", "chen@grid32")
LAT_ACT_STEPS = {8: 32, 32: 16}                  # by n_nodes
# the JAX package's choices at 8 nodes (a CPU run of repro.core.dse):
# select_config(24, 64, s_total=256, float32, n_nodes=8), the no-config
# stream's, and select(24, 64, "pareto", n_nodes=8), the generated cores'
LAT_STREAM_CONFIG = dict(i_dim=24, h_dim=64, p=1, compute_unit="vpu",
                         dtype_bytes=4, unroll=8, t_block=256, n_nodes=8)
LAT_SELECT = dict(i_dim=24, h_dim=64, p=3, compute_unit="vpu",
                  dtype_bytes=2, unroll=8, t_block=256, n_nodes=8)
LAT_CORES = ("chen@ring8", "chen@grid8")        # generated, with testbench
# the stream's words held bitwise against the plain path: its first 256
# word rows (the plain loop's launches, not its lanes, set its time; cut
# to pay for phase 15's time)
LAT_STREAM_CHECK_WORDS = 1 << 16
# the generated lattice cores' generate / generate_bits steps (the plain
# dense loop's launches set the checks' time)
LAT_CORE_STEPS = 128
LAT_ATTRACTOR_STEPS = 1_000
# lattice K1/K2 timed at lattice K1's served shape (the lattice path's)
LAT_TIME_LANES, LAT_TIME_STEPS = 65_536, 256

# phase 13, tanh and sigmoid in the mxu forms: phases 10 and 11's nets.
# K1/K2 checked at every MXU_SHAPES entry at (lanes, steps) by n_nodes
# (the plain f32 FMA chains' launches set their time; steps at 1 and 8
# nodes halved to pay for phase 16's time), K3 at phase_mxu_gang_kernels'
# blocks, steps and rows
MXU_ACT_CHECKS = {1: (4_096 + 37, 32), 8: (1_024 + 37, 8),
                  32: (512 + 37, 4)}
# the JAX package's choices (a CPU run of repro.core.dse): the no-config
# streams' select_config(3n, 8n, s_total=256, dtype, n_nodes=n), mxu at
# chen@ring32 in both dtypes and at bf16 chen@ring8, and select(24, 64,
# "min_latency", n_nodes=8), the generated cores'
MXU_STREAMS = (("chen@ring32", "f32"), ("chen@ring32", "bf16"),
               ("chen@ring8", "bf16"))
MXU_STREAM_CONFIG = dict(p=1, compute_unit="mxu", unroll=8, t_block=256)
MXU_SELECT = dict(i_dim=24, h_dim=64, p=5, compute_unit="mxu",
                  dtype_bytes=2, unroll=8, t_block=128, n_nodes=8)
# each stream's first words held against the plain path (seconds of plain
# f32 chains at ring32), the lattices iterated (steps by n_nodes),
# and the generated cores' generate / generate_bits steps, all cut to pay
# for phase 15's time
MXU_STREAM_CHECK_WORDS = 1 << 11
MXU_ATTRACTOR_STEPS = {32: 16, 8: 64}
MXU_CORE_STEPS = 32
# the farm's gang launches replayed on their first word rows (a ring32
# plain f32 gang scan costs about 0.1 s a core a step)
MXU_REPLAY_ROWS = 2
# mxu K1/K2 timed at the mxu path's shape; the plain run on the first lanes
MXU_TIME_LANES, MXU_TIME_STEPS, MXU_TIME_PLAIN_LANES = 65_536, 64, 1_024


# phase 16, the LM stack
LM_SERVE = (("llama3_2_3b", None), ("qwen3_moe_30b_a3b", 2))  # (arch, layers)
LM_PROMPTS, LM_PROMPT_LEN, LM_NEW = 4, 64, 32
LM_LAST_TOL = 1e-2           # prefill's last logits vs forward(last_only), bf16
LM_CPU_LAYERS, LM_CPU_TOKENS = 2, (2, 16)
LM_CPU_TOL = 1e-4            # f32 card vs CPU logits, of their max magnitude
LM_TRAIN = dict(layers=4, global_batch=8, seq_len=512, num_microbatches=2,
                steps=4)
# NVIDIA's H100 SXM data sheet: dense bf16 tensor-core peak at 700 W
H100_BF16_DENSE_FLOPS = 989e12


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def register_report(log: str) -> str:
    """The most registers any kernel uses, and nvcc's ``-Xptxas -v`` lines
    that report a nonzero spill."""
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = [line.strip() for line in log.splitlines()
              if re.search(r"\b[1-9]\d* bytes spill", line)]
    return (f"{len(regs)} kernels, at most {max(regs, default=0)} registers; "
            f"spills: {'; '.join(spills) or 'none'}")


def mangled(name: str, args) -> str:
    """The Itanium-mangled ``name<args>`` as it stands in nvcc's and
    cuobjdump's output: int arguments, ``"f"`` for float, ``"bf16"`` for
    __nv_bfloat16."""
    parts = "".join("13__nv_bfloat16" if a == "bf16" else a
                    if isinstance(a, str) else f"Li{a}E" for a in args)
    return f"{len(name)}{name}I{parts}E"


def kernel_registers(log: str, name: str) -> str:
    """Registers and spills of every instantiation of kernel ``name`` in
    nvcc's ``-Xptxas -v`` log."""
    regs, spills = [], set()
    for entry in log.split("Compiling entry function '")[1:]:
        fn = entry.split("'", 1)[0]
        if f"{len(name)}{name}I" not in fn:
            continue
        m = re.search(r"Used (\d+) registers", entry)
        regs.append(int(m.group(1)) if m else -1)
        spills |= {int(n) for n in re.findall(r"(\d+) bytes spill", entry)}
    return (f"{name}: {len(regs)} instantiations, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers, spill bytes "
            f"{sorted(spills) or [0]}")


def sass_dump_start(lib_path):
    """Start ``cuobjdump -sass`` of the built library (on PATH or beside
    nvcc) into a file beside it, so that it runs beside the later phases;
    returns (process, file), or None when there is no cuobjdump."""
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump")
    if tool is None:
        beside = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
        tool = str(beside) if beside.exists() else None
    if tool is None:
        return None
    out = open(pathlib.Path(lib_path).with_suffix(".sass"), "w+")
    return subprocess.Popen([tool, "-sass", str(lib_path)], stdout=out), out


def sass_counts(dump):
    """Per SASS_KERNELS entry: its SASS instructions and those of
    SASS_OPS, in the whole kernel and in its widest loop (the span of its
    longest backward branch: the row loop), from the dump
    ``sass_dump_start`` started; says so when there is no cuobjdump.
    Fails where a row loop holds an op that SASS_FREE excludes, or a
    sigmoid loop (activation code 2) an f64 conversion.
    Returns (report, {"name<args>": instructions in its widest loop})."""
    if dump is None:
        return "no cuobjdump on PATH or beside nvcc: SASS not counted", {}
    proc, out = dump
    check(proc.wait(timeout=600) == 0, "cuobjdump -sass failed")
    want = {mangled(n, a): f"{n}<{', '.join(map(str, a))}>"
            for n, a in SASS_KERNELS}
    free = {mangled(n, a): ops for (n, a), ops in SASS_FREE.items()}
    code, current = {}, None          # kernel -> [(address, opcode, line)]
    op_re = re.compile(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)(.*)")
    out.seek(0)
    for line in out:
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            current = next((k for k in want if k in fn), None)
            if current is not None:
                code[current] = []
            continue
        m = op_re.search(line) if current is not None else None
        if m:
            code[current].append((int(m.group(1), 16), m.group(2),
                                  m.group(3)))

    def ops(ins):
        c = dict.fromkeys(SASS_OPS, 0)
        for _, op, rest in ins:
            if op in c:
                c[op] += 1
            mods = rest.split(" ", 1)[0]
            if op == "STG" and ".128" in mods:
                c["STG.128"] += 1
            if op == "F2F" and ".BF16" in mods:
                c["F2F.BF16"] += 1
            if op == "F2F" and ".F64" in mods:
                c["F2F.F64"] += 1
        return c

    def count(ins):
        c = ops(ins)
        return f"{len(ins)} ({', '.join(f'{k} {v}' for k, v in c.items())})"

    def widest_loop(ins):
        spans = [(int(t.group(1), 16), addr) for addr, op, rest in ins
                 if op == "BRA" and (t := re.search(r"0x([0-9a-f]+)", rest))
                 and int(t.group(1), 16) < addr]
        if not spans:
            return []
        lo, hi = max(spans, key=lambda sp: sp[1] - sp[0])
        return [x for x in ins if lo <= x[0] <= hi]

    report = "; ".join(
        f"{label}: " + (f"all {count(code[k0])}, loop "
                        f"{count(widest_loop(code[k0]))}"
                        if k0 in code else "not found")
        for k0, label in want.items())
    for k0, label in want.items():
        check(k0 in code, f"SASS of {label} not found")
        loop = ops(widest_loop(code[k0]))
        banned = free.get(k0, ()) + (("F2F.F64",) if label.endswith(", 2>")
                                    else ())
        held = {op: loop[op] for op in banned if loop[op]}
        check(not held, f"{label}'s row loop holds {held}")
    return report, {label: len(widest_loop(code[k0]))
                    for k0, label in want.items() if k0 in code}


def fill_chain_floors(rows, loops) -> None:
    """``chain_floor_ms_f2`` of each ``kernels`` row of the scalar K3 that
    ran a ragged F2 (its ``f2_hot_rows``): one thread's chain of the hot
    block's rows, at the SASS instructions a row of its row loop
    (``bf16x2_gang_bits_kernel`` or ``f32_gang_bits_kernel`` at 3-8 in
    SASS_KERNELS; a row is two steps), one warp issuing at most one
    instruction a clock at the boost clock.  The hot blocks are a few CTAs
    (the farm's F2: chen's 128 of 512, about one an SM, a warp a
    scheduler), so that chain, not the card's op rate, bounds the launch
    when it is the larger.  None without the count."""
    codes = {"relu": 0, "tanh": 1, "sigmoid": 2}
    labels = {"bf16x2_gang_bits_kernel": "bf16x2_gang_bits_kernel<3, 8, {}>",
              "f32_gang_bits_kernel": "f32_gang_bits_kernel<3, 8, {}>"}
    for row in rows:
        if row.get("kernel") not in labels or "f2_hot_rows" not in row:
            continue
        act = row["name"].split("/")[1] if row["name"].count("/") == 2 \
            else "relu"
        label = labels[row["kernel"]].format(codes[act])
        n = loops.get(label)
        row["loop_sass"] = n
        row["chain_floor_ms_f2"] = (None if n is None else
                                    n * row["f2_hot_rows"] / H100_BOOST_HZ
                                    * 1e3)
        print(f"F2 chain floor {row['name']} ({row['path']}): {label} {n} "
              f"SASS a row x {row['f2_hot_rows']} rows at "
              f"{H100_BOOST_HZ / 1e9} GHz = {row['chain_floor_ms_f2']} ms; "
              f"ops bound {row.get('bound_ms_f2', row['bound_ms'])} ms; "
              f"measured {row.get('ms_f2', row['ms'])} ms")


def sass_dump_stop(dump) -> None:
    """End the dump's process if it still runs, and close its file."""
    if dump is not None:
        proc, out = dump
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events.
    The calls are queued behind a spin of the device (QUEUE_SPIN_CYCLES),
    so the host's work in each call (the wrapper's checks, its small
    copies) overlaps the device's and no idle gap between two launches
    is counted, as it was where the host took longer than a sub-ms
    kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(torch, fn):
    """``fn()``'s result and its device time in ms: one call, by CUDA
    events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def bound(flops: float, n_bytes: float, rate: str, f32_flops: float = 0.0,
          add_ops: float = 0.0, add_rate: str = "f32"):
    """The least time for ``flops`` at ``PEAK_OPS[rate]`` (a vpu state
    dtype's instruction rate, or ``"mxu"``) plus ``f32_flops`` at the f32
    vpu rate plus ``add_ops`` at ``PEAK_OPS[add_rate]``, or for
    ``n_bytes`` at HBM bandwidth, whichever is larger."""
    ops_ms = (flops / PEAK_OPS[rate] + f32_flops / PEAK_OPS["f32"]
              + add_ops / PEAK_OPS[add_rate]) * 1e3
    bytes_ms = n_bytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def step_flops(i_dim: int, h_dim: int) -> int:
    """Separate ops one step needs, each in the state dtype: each of the H
    hidden sums is I products, I - 1 adds and the bias add, and each of
    the I outputs H products, H - 1 adds and the bias add: 4*I*H.  The
    reference's first add (+0 + the first product) changes no value
    (``bf16x2_bits_kernel``'s sums start from their first term, bitwise
    the same), and relu is a select, not counted."""
    return 4 * i_dim * h_dim


def act_flops(h_dim: int, activation: str) -> int:
    """Ops the activation's formula adds to a step over ``h_dim`` hidden
    units (0 for relu), f32 ops in both state dtypes."""
    return h_dim * ACT_OPS[activation]


def lattice_step_flops(lattice, h_dim: int, activation: str = "relu") -> int:
    """Ops of one lattice step (``h_dim`` the lattice-expanded hidden
    width, n_nodes x HB), block-sparse work only: each node's base step,
    plus the coupling's ops per state component (ring: neighbour sum 1,
    deg*x, difference, scale, add into y; torus: 3 sums), plus with tanh
    or sigmoid the formula's ops on every hidden unit of every node
    (``act_flops``; 888 / 1,912 / 2,232 ops at chen@ring8 for relu /
    tanh / sigmoid, 3,552 / 7,648 / 8,928 at chen@ring32)."""
    n_nodes, base_dim, topology, _ = lattice
    per_component = 5 if topology == "ring" else 7
    return (n_nodes * step_flops(base_dim, h_dim // n_nodes)
            + per_component * n_nodes * base_dim + act_flops(h_dim, activation))


def mxu_step_flops(i_dim: int, h_dim: int, lattice,
                   activation: str = "relu") -> tuple:
    """Ops of one mxu step as (FMA flops, adds, formula ops).  The first:
    the nonzero terms of its dense dots, each a fused multiply-add of 2
    flops, at the mxu rate.  Scalar: every term of the two dots (4*I*H).
    Lattice: each node's blocks and the coupling's 3 (ring) or 5 (torus)
    terms a component (a torus side of 2 repeats a neighbour: one term
    fewer).  The second: the separate adds in the state dtype (H + I
    biases, for a lattice I coupling adds), one instruction an op at the
    state dtype's vpu rate (packed bf16x2 in bf16, as the vpu bf16 rows);
    the third: the activation's formula, f32 ops in both dtypes at the f32
    vpu rate (``mxu_bound``)."""
    adds = h_dim + i_dim + (i_dim if lattice is not None else 0)
    act = act_flops(h_dim, activation)
    if lattice is None:
        return step_flops(i_dim, h_dim), adds, act
    n_nodes, base_dim, topology, _ = lattice
    from repro_torch.core.chaotic import lattice_coupling_matrix
    terms = int((lattice_coupling_matrix(n_nodes, base_dim, 1.0, topology)
                 != 0).sum())
    return (n_nodes * step_flops(base_dim, h_dim // n_nodes) + 2 * terms,
            adds, act)


def mxu_bound(lane_steps: float, step: tuple, n_bytes: float, tag: str):
    """``bound`` of ``lane_steps`` mxu steps of ``mxu_step_flops``'s
    ``step`` in state dtype ``tag``: the FMA flops at the mxu rate, the
    adds at the ``tag`` rate, the formula ops at the f32 rate."""
    fma, adds, act = step
    return bound(lane_steps * fma, n_bytes, "mxu", f32_flops=lane_steps * act,
                 add_ops=lane_steps * adds, add_rate=tag)


def mxu_dense_flops(i_dim: int, h_dim: int, lattice) -> int:
    """Ops of one mxu step counted over the dense dots, zero terms too:
    2 per fused multiply-add of (I x H), (H x I) and, for a lattice, the
    (I x I) coupling, plus the bias and coupling adds."""
    fmas = 2 * i_dim * h_dim + (i_dim * i_dim if lattice else 0)
    return 2 * fmas + h_dim + i_dim + (i_dim if lattice else 0)


def max_abs_err(torch, a, b) -> float:
    """Bitwise agreement check; returns the largest absolute difference
    (0.0 when every element is bit-identical)."""
    if a.dtype == torch.uint32:
        ia = a.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        ib = b.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return float((ia - ib).abs().max().item())
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    if torch.equal(a.view(bits), b.view(bits)):
        return 0.0
    diff = (a.float() - b.float()).abs().nan_to_num(nan=float("inf"))
    return float(diff.max().item())


def masked_err(torch, a, b, lane_rows) -> float:
    """``max_abs_err`` over the words each lane asked for: row r of lane
    l counts when r < lane_rows[l] (the rows past it are unwritten)."""
    rows = torch.arange(a.shape[0], device=a.device)
    mask = rows.reshape((-1,) + (1,) * (a.ndim - 1)) < lane_rows
    ia = a.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ib = b.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return float(torch.where(mask, (ia - ib).abs(), 0).max().item())


def gang_weights(torch, device, gang):
    """The stacked (C, ...) weights of one of GANGS, on the card."""
    from repro_torch.prng.stream import default_params
    per_core = []
    for name in GANGS[gang]:
        if name.startswith("registry:"):
            p = default_params(system=name.split(":")[1])
        else:
            with np.load(FARM_DIR / name / "weights.npz") as npz:
                p = dict(npz)
        per_core.append([np.asarray(p[k], np.float32)
                         for k in ("w1", "b1", "w2", "b2")])
    return [torch.as_tensor(np.stack(ws), device=device)
            for ws in zip(*per_core)]


def phase_gang_kernels(torch, device, errs) -> None:
    """K3 and K4 against their plain versions on the card, bitwise."""
    from repro_torch.kernels import chaotic_ann, ref

    rng = np.random.default_rng(1)
    n_rows = CHECK_STEPS // 2
    for gang in sorted(GANGS):
        w = gang_weights(torch, device, gang)
        n_cores, i_dim = w[0].shape[0], w[0].shape[1]
        n_lanes = GANG_BLOCKS * GANG_S_BLOCK
        core_map = np.arange(GANG_BLOCKS) % n_cores
        x0_np = rng.uniform(-0.9, 0.9, (n_lanes, i_dim)).astype(np.float32)
        off_np = rng.integers(0, 1 << 32, n_lanes, dtype=np.int64)
        off_np[:64] = (1 << 32) - 1 - 3 * np.arange(64)    # wrap mid-run
        off = torch.as_tensor(off_np, device=device)
        xs_np = rng.uniform(-0.9, 0.9, (n_cores, STACK_LANES, i_dim)
                            ).astype(np.float32)
        offs_np = rng.integers(0, 1 << 32, (n_cores, STACK_LANES),
                               dtype=np.int64)
        offs_np[:, :16] = (1 << 32) - 1 - 5 * np.arange(16)
        offs = torch.as_tensor(offs_np, device=device)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x0 = torch.as_tensor(x0_np, device=device).to(dtype)
            xs = torch.as_tensor(xs_np, device=device).to(dtype)
            for shape in ("padded", "ragged"):
                row_map = K3_ROW_MAP if shape == "ragged" else None
                rows = (chaotic_ann.gang_effective_rows(
                    row_map, CHECK_STEPS, FARM_T_BLOCK, FARM_UNROLL)
                    if row_map is not None
                    else np.full(GANG_BLOCKS, n_rows, np.int32))
                words_k, state_k = chaotic_ann.chaotic_ann_gang_bits(
                    *w, x0, core_map, off, row_map, n_steps=CHECK_STEPS,
                    s_block=GANG_S_BLOCK, t_block=FARM_T_BLOCK,
                    unroll=FARM_UNROLL)
                words_p, state_p = ref.chaotic_ann_gang_bits_ref(
                    *w, x0, core_map, CHECK_STEPS, off, rows)
                lane_rows = torch.as_tensor(
                    np.repeat(rows, GANG_S_BLOCK).astype(np.int64),
                    device=device)
                e3 = max(masked_err(torch, words_k, words_p, lane_rows),
                         max_abs_err(torch, state_k, state_p))
                srow_map = K4_ROW_MAP[:n_cores] if shape == "ragged" else None
                srows = np.minimum(srow_map if srow_map is not None
                                   else n_rows, n_rows)
                words_k, state_k = chaotic_ann.chaotic_ann_gang_stacked(
                    *w, xs, offs, srow_map, n_steps=CHECK_STEPS)
                words_p, state_p = ref.chaotic_ann_gang_stacked_ref(
                    *w, xs, CHECK_STEPS, offs, srow_map)
                core_rows = torch.as_tensor(
                    np.broadcast_to(srows, (n_cores,)).astype(np.int64),
                    device=device)[:, None]
                e4 = max(masked_err(torch, words_k, words_p, core_rows),
                         max_abs_err(torch, state_k, state_p))
                torch.cuda.synchronize()
                print(f"check gang {gang} {tag} {shape}: "
                      f"chaotic_ann_gang_bits (C={n_cores}, {GANG_BLOCKS} "
                      f"blocks x {GANG_S_BLOCK} lanes, rows "
                      f"{sorted(set(rows.tolist()))}) max_abs_err={e3}; "
                      f"chaotic_ann_gang_stacked (C={n_cores} x "
                      f"{STACK_LANES} lanes, rows {srows.tolist()}) "
                      f"max_abs_err={e4}")
                check(e3 == 0.0, f"chaotic_ann_gang_bits != plain "
                                 f"({gang}, {tag}, {shape})")
                check(e4 == 0.0, f"chaotic_ann_gang_stacked != plain "
                                 f"({gang}, {tag}, {shape})")
                for name, e in (("chaotic_ann_gang_bits", e3),
                                ("chaotic_ann_gang_stacked", e4)):
                    errs[(name, tag)] = max(errs.get((name, tag), 0.0), e)


def lattice_gang_weights(torch, device, system):
    """The stacked (4, ...) weights, on the card, of the four 3-8 bases as
    lattices of ``system``'s descriptor (``chen@ring32``: chen, chua,
    lorenz and rossler @ring32, derived from their committed weights), and
    that descriptor."""
    from repro_torch.core.ann import lattice_meta_tuple
    from repro_torch.prng.stream import default_params
    topology = system.split("@")[1]
    per_core = [default_params(system=f"{b}@{topology}")
                for b in GANGS["3-8"]]
    w = [torch.as_tensor(np.stack([p[k] for p in per_core]), device=device)
         for k in ("w1", "b1", "w2", "b2")]
    return w, lattice_meta_tuple(per_core[0]["lattice_meta"])


def phase_lattice_gang_kernels(torch, device, errs) -> None:
    """The lattice forms of K3 and K4 against their plain versions on the
    card, bitwise: the words each block or core asked for, and the final
    states."""
    from repro_torch.kernels import chaotic_ann, ref

    rng = np.random.default_rng(2)
    n_steps = LATTICE_CHECK_STEPS
    n_lanes = LATTICE_GANG_BLOCKS * LATTICE_GANG_S_BLOCK
    core_map = np.arange(LATTICE_GANG_BLOCKS) % 4
    rows = chaotic_ann.gang_effective_rows(LATTICE_K3_ROW_MAP, n_steps,
                                           FARM_T_BLOCK, FARM_UNROLL)
    srows = np.minimum(LATTICE_K4_ROW_MAP, n_steps // 2)
    lane_rows = torch.as_tensor(
        np.repeat(rows, LATTICE_GANG_S_BLOCK).astype(np.int64), device=device)
    core_rows = torch.as_tensor(srows.astype(np.int64), device=device)[:, None]
    for system in LATTICE_GANG_CHECKS:
        w, lattice = lattice_gang_weights(torch, device, system)
        i_dim = w[0].shape[1]
        x0_np = rng.uniform(-0.9, 0.9, (n_lanes, i_dim)).astype(np.float32)
        off_np = rng.integers(0, 1 << 32, n_lanes, dtype=np.int64)
        off_np[:64] = (1 << 32) - 1 - 3 * np.arange(64)    # wrap mid-run
        off = torch.as_tensor(off_np, device=device)
        xs_np = rng.uniform(-0.9, 0.9, (4, LATTICE_STACK_LANES, i_dim)
                            ).astype(np.float32)
        offs_np = rng.integers(0, 1 << 32, (4, LATTICE_STACK_LANES),
                               dtype=np.int64)
        offs_np[:, :16] = (1 << 32) - 1 - 5 * np.arange(16)
        offs = torch.as_tensor(offs_np, device=device)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x0 = torch.as_tensor(x0_np, device=device).to(dtype)
            xs = torch.as_tensor(xs_np, device=device).to(dtype)
            words_k, state_k = chaotic_ann.chaotic_ann_gang_bits(
                *w, x0, core_map, off, LATTICE_K3_ROW_MAP, n_steps=n_steps,
                s_block=LATTICE_GANG_S_BLOCK, t_block=FARM_T_BLOCK,
                unroll=FARM_UNROLL, lattice=lattice)
            words_p, state_p = ref.chaotic_ann_gang_bits_ref(
                *w, x0, core_map, n_steps, off, rows, lattice=lattice)
            e3 = max(masked_err(torch, words_k, words_p, lane_rows),
                     max_abs_err(torch, state_k, state_p))
            words_k, state_k = chaotic_ann.chaotic_ann_gang_stacked(
                *w, xs, offs, LATTICE_K4_ROW_MAP, n_steps=n_steps,
                lattice=lattice)
            words_p, state_p = ref.chaotic_ann_gang_stacked_ref(
                *w, xs, n_steps, offs, LATTICE_K4_ROW_MAP, lattice=lattice)
            e4 = max(masked_err(torch, words_k, words_p, core_rows),
                     max_abs_err(torch, state_k, state_p))
            torch.cuda.synchronize()
            print(f"check lattice gang {system} {tag}: "
                  f"chaotic_ann_lattice_gang_bits (C=4, "
                  f"{LATTICE_GANG_BLOCKS} blocks x {LATTICE_GANG_S_BLOCK} "
                  f"lanes, steps={n_steps}, rows "
                  f"{sorted(set(rows.tolist()))}) max_abs_err={e3}; "
                  f"chaotic_ann_lattice_gang_stacked (C=4 x "
                  f"{LATTICE_STACK_LANES} lanes, rows {srows.tolist()}) "
                  f"max_abs_err={e4}")
            check(e3 == 0.0, f"chaotic_ann_lattice_gang_bits != plain "
                             f"({system}, {tag})")
            check(e4 == 0.0, f"chaotic_ann_lattice_gang_stacked != plain "
                             f"({system}, {tag})")
            for name, e in (("chaotic_ann_lattice_gang_bits", e3),
                            ("chaotic_ann_lattice_gang_stacked", e4)):
                errs[(name, tag)] = max(errs.get((name, tag), 0.0), e)


def mxu_gang_operands(torch, device, gang):
    """The stacked weights on the card of one of MXU_GANG_CHECKS, its
    lattice descriptor and its one shared coupling operand (None, None
    for a scalar gang)."""
    from repro_torch.prng.stream import default_params
    if gang in GANGS:
        return gang_weights(torch, device, gang), None, None
    w, lattice = lattice_gang_weights(torch, device, gang)
    cpl = torch.as_tensor(default_params(system=gang)["coupling"],
                          device=device)
    return w, lattice, cpl


def phase_mxu_gang_kernels(torch, device, errs) -> None:
    """K3's mxu form against its plain version on the card, bitwise, at
    every MXU_SHAPES entry, padded and ragged: the words each block asked
    for, and the final states."""
    from repro_torch.kernels import chaotic_ann, ref

    rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    n_lanes = MXU_GANG_BLOCKS * MXU_GANG_S_BLOCK
    for gang in MXU_GANG_CHECKS:
        w, lattice, cpl = mxu_gang_operands(torch, device, gang)
        n_cores, i_dim = w[0].shape[0], w[0].shape[1]
        n_steps = MXU_GANG_STEPS[lattice[0] if lattice else 1]
        core_map = np.arange(MXU_GANG_BLOCKS) % n_cores
        x0_np = rng.uniform(-0.9, 0.9, (n_lanes, i_dim)).astype(np.float32)
        off_np = rng.integers(0, 1 << 32, n_lanes, dtype=np.int64)
        off_np[:64] = (1 << 32) - 1 - 3 * np.arange(64)    # wrap mid-run
        off = torch.as_tensor(off_np, device=device)
        kw = dict(lattice=lattice, compute_unit="mxu", coupling=cpl)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x0 = torch.as_tensor(x0_np, device=device).to(dtype)
            for shape in ("padded", "ragged"):
                row_map = LATTICE_K3_ROW_MAP if shape == "ragged" else None
                rows = (chaotic_ann.gang_effective_rows(
                    row_map, n_steps, MXU_GANG_T_BLOCK, MXU_GANG_UNROLL)
                    if row_map is not None
                    else np.full(MXU_GANG_BLOCKS, n_steps // 2, np.int32))
                words_k, state_k = chaotic_ann.chaotic_ann_gang_bits(
                    *w, x0, core_map, off, row_map, n_steps=n_steps,
                    s_block=MXU_GANG_S_BLOCK, t_block=MXU_GANG_T_BLOCK,
                    unroll=MXU_GANG_UNROLL, **kw)
                words_p, state_p = ref.chaotic_ann_gang_bits_ref(
                    *w, x0, core_map, n_steps, off, rows, **kw)
                lane_rows = torch.as_tensor(
                    np.repeat(rows, MXU_GANG_S_BLOCK).astype(np.int64),
                    device=device)
                e = max(masked_err(torch, words_k, words_p, lane_rows),
                        max_abs_err(torch, state_k, state_p))
                torch.cuda.synchronize()
                print(f"check mxu gang {gang} {tag} {shape}: "
                      f"chaotic_ann_mxu_gang_bits (C={n_cores}, "
                      f"{MXU_GANG_BLOCKS} blocks x {MXU_GANG_S_BLOCK} lanes, "
                      f"steps={n_steps}, rows {sorted(set(rows.tolist()))}) "
                      f"max_abs_err={e}")
                check(e == 0.0, f"chaotic_ann_mxu_gang_bits != plain "
                                f"({gang}, {tag}, {shape})")
                key = ("chaotic_ann_mxu_gang_bits", tag)
                errs[key] = max(errs.get(key, 0.0), e)
    print(f"mxu gang kernel checks: {time.perf_counter() - t0:.1f} s")


def kernel_names(lattice, unit="vpu"):
    """The (K1, K2) wrappers whose counters a core's launches move: the
    mxu forms on the mxu unit; on the vpu the scalar kernels, or the
    lattice forms for a lattice core (``lattice`` its descriptor, or any
    true value)."""
    if unit == "mxu":
        return "chaotic_ann_mxu_bits", "chaotic_ann_mxu_traj"
    if not lattice:
        return "chaotic_ann_bits", "chaotic_ann_traj"
    return "chaotic_ann_lattice_bits", "chaotic_ann_lattice_traj"


def phase_kernels(torch, device, errs) -> None:
    """K1 and K2, scalar, lattice and mxu forms, against their plain
    versions on the card, bitwise; each plain K1 is one plain scan packed
    by ``ops.pack_words``, the scan K2 is held against."""
    from repro_torch.core.ann import lattice_meta_tuple, params_from_numpy
    from repro_torch.kernels import chaotic_ann, ops, ref
    from repro_torch.prng.stream import default_params

    rng = np.random.default_rng(0)
    for system, n_lanes, n_steps in CHECKS:
        p = params_from_numpy(default_params(system=system), device=device)
        w = (p["w1"], p["b1"], p["w2"], p["b2"])
        lattice = (lattice_meta_tuple(p["lattice_meta"])
                   if "lattice_meta" in p else None)
        i_dim = p["w1"].shape[0]
        x0_np = rng.uniform(-0.9, 0.9, (n_lanes, i_dim)).astype(np.float32)
        off_np = rng.integers(0, 1 << 32, n_lanes, dtype=np.int64)
        off_np[:64] = (1 << 32) - 1 - 3 * np.arange(64)    # wrap mid-run
        off = torch.as_tensor(off_np, device=device)
        for unit in ("vpu", "mxu"):
            bits_name, traj_name = kernel_names(lattice, unit)
            kw = dict(lattice=lattice, compute_unit=unit, coupling=(
                p["coupling"] if unit == "mxu" and lattice else None))
            for dtype, tag in ((torch.float32, "f32"),
                               (torch.bfloat16, "bf16")):
                x0 = torch.as_tensor(x0_np, device=device).to(dtype)
                words_k, state_k = chaotic_ann.chaotic_ann_bits(
                    *w, x0, off, n_steps=n_steps, **kw)
                traj_k = chaotic_ann.chaotic_ann_traj(*w, x0,
                                                      n_steps=n_steps, **kw)
                traj_p = ref.chaotic_ann_ref(*w, x0, n_steps, **kw)
                words_p = ops.pack_words(traj_p, off)
                torch.cuda.synchronize()
                e_bits = max(max_abs_err(torch, words_k, words_p),
                             max_abs_err(torch, state_k, traj_p[-1]))
                e_traj = max_abs_err(torch, traj_k, traj_p)
                print(f"check {system} {unit} {tag} S={n_lanes} "
                      f"steps={n_steps}: {bits_name} max_abs_err={e_bits}"
                      f" {traj_name} max_abs_err={e_traj}"
                      f" max|x|={traj_p.float().abs().max().item():.6g}")
                check(e_bits == 0.0,
                      f"{bits_name} != plain ({system}, {unit}, {tag})")
                check(e_traj == 0.0,
                      f"{traj_name} != plain ({system}, {unit}, {tag})")
                for name, e in ((bits_name, e_bits), (traj_name, e_traj)):
                    errs[(name, tag)] = max(errs.get((name, tag), 0.0), e)
                del traj_k, traj_p


BF16X2_CHECK_OPS = (
    "add.rn vs __float2bfloat16_rn(f32 add) on 2^32 operand pairs",
    "sub.rn vs __float2bfloat16_rn(f32 sub) on 2^32 operand pairs",
    "mul.rn vs __float2bfloat16_rn(f32 mul) on 2^32 operand pairs",
    "fma.rn.relu(a, 1, b) vs relu(bf16(a + b)), zero sums +0, on 2^32 "
    "operand pairs",
    "tanh of two lanes vs the round-trip tanh on 2^16 inputs",
    "sigmoid of two lanes vs the round-trip sigmoid on 2^16 inputs",
    "tanh's f32 result with div_fast (the mxu step's) vs __fdiv_rn's on "
    "2^16 inputs",
    "sigmoid's f32 result with div_fast (the mxu step's) vs __fdiv_rn's on "
    "2^16 inputs",
    "cvt.rn.bf16x2.f32 vs __float2bfloat16_rn on 2^32 f32 inputs, both "
    "halves",
    "f32 tanh with div_fast (every f32 step's, phi_f32) vs __fdiv_rn's on "
    "2^32 f32 inputs",
    "f32 sigmoid with div_fast and exp_f32 (every f32 step's, phi_f32) vs "
    "__fdiv_rn's and exp_f32_f64 on 2^32 f32 inputs",
    "exp_f32 (2^fx added to the exponent field in f32 bits) vs "
    "exp_f32_f64 (the f64 scaling) on 2^32 f32 inputs")


def bf16x2_exhaustive(torch, device) -> None:
    """The bf16x2 ops the bf16 K1 computes with (add, sub and
    mul.rn.bf16x2) against the round-trip form (__float2bfloat16_rn of the
    f32 op), and its fused bias add and relu (fma.rn.relu.bf16x2) against
    relu of that sum with a zero sum +0, on all 2^32 operand pairs each;
    its tanh and sigmoid of two lanes (the divisions without the slow
    path) against the round-trip kernels' on every bf16 input, and the f32
    results the bf16 mxu K1 reads from them against the __fdiv_rn form's,
    bitwise in f32; cvt.rn.bf16x2.f32 against __float2bfloat16_rn on every
    f32 input in either half; the f32 kernels' tanh and sigmoid
    (div_fast, exp_f32's scaling in f32 bits) against the __fdiv_rn form
    with exp's f64 scaling, and exp_f32 against that f64 form, on every
    f32 input; on the card, through the library's check hook; a NaN counts
    equal to any NaN.  Fails on any mismatch."""
    from repro_torch.kernels import chaotic_ann
    fn = chaotic_ann._lib().chaotic_ann_bf16x2_check_launch
    n_ops = len(BF16X2_CHECK_OPS)
    mismatches = torch.zeros(n_ops, dtype=torch.int64, device=device)
    n_examples = torch.zeros(n_ops, dtype=torch.int32, device=device)
    examples = torch.zeros((n_ops, 4, 4), dtype=torch.int32, device=device)
    rc, ms = timed_once(torch, lambda: fn(
        device.index, mismatches.data_ptr(), n_examples.data_ptr(),
        examples.data_ptr(), torch.cuda.current_stream(device).cuda_stream))
    check(rc == 0, f"bf16x2 check kernel did not launch (code {rc})")
    counts = mismatches.tolist()
    shown = (examples.to(torch.int64) & 0xFFFFFFFF).tolist()
    for op, name in enumerate(BF16X2_CHECK_OPS):
        ex = [f"a=0x{a:x} b=0x{b:x} got=0x{got:x} want=0x{want:x}"
              for a, b, got, want in shown[op][:min(4, counts[op])]]
        print(f"bf16x2 {name}: {counts[op]} mismatches"
              + (f" (e.g. {'; '.join(ex)})" if ex else ""))
    print(f"bf16x2 exhaustive check: {ms:.1f} ms on the card")
    check(sum(counts) == 0, f"bf16x2 ops differ from the round-trip form: "
                            f"{counts}")


def phase_bf16x2(torch, device, log, errs) -> None:
    """The bf16 K1 on bf16x2: its ops on every operand pair; both kernels
    bitwise their plain versions at tiny and odd lane counts
    (BF16X2_CHECKS) with relu, tanh and sigmoid, tanh's and sigmoid's
    words unlike relu's; the two-lane mxu K1 likewise (MXU_X2_CHECKS) in
    f32 and bf16; their registers and spills from the build log."""
    from repro_torch.core.ann import lattice_meta_tuple, params_from_numpy
    from repro_torch.kernels import chaotic_ann, ref
    from repro_torch.prng.stream import default_params

    bf16x2_exhaustive(torch, device)
    rng = np.random.default_rng(22)
    both = ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
    for unit, checks, dtypes in (
            ("vpu", BF16X2_CHECKS, both[1:]), ("mxu", MXU_X2_CHECKS, both)):
        for system, counts, n_steps in checks:
            p = params_from_numpy(default_params(system=system),
                                  device=device)
            w = (p["w1"], p["b1"], p["w2"], p["b2"])
            lattice = (lattice_meta_tuple(p["lattice_meta"])
                       if "lattice_meta" in p else None)
            kw = dict(lattice=lattice, compute_unit=unit, coupling=(
                p["coupling"] if unit == "mxu" and lattice else None))
            n_max, i_dim = max(counts), p["w1"].shape[0]
            x0_f = torch.as_tensor(rng.uniform(-0.9, 0.9, (n_max, i_dim)),
                                   dtype=torch.float32, device=device)
            off_np = rng.integers(0, 1 << 32, n_max, dtype=np.int64)
            off_np[:2] = (1 << 32) - 1, (1 << 32) - 3      # wrap mid-run
            off = torch.as_tensor(off_np, device=device)
            name = kernel_names(lattice, unit)[0]
            for dtype, tag in dtypes:
                x0 = x0_f.to(dtype)
                relu_words = None
                for act in ("relu", "tanh", "sigmoid"):
                    words_p, state_p = ref.chaotic_ann_bits_ref(
                        *w, x0, n_steps, off, act, **kw)
                    words_p = words_p.view(torch.int32)
                    e_all = 0.0
                    for n in counts:
                        words_k, state_k = chaotic_ann.chaotic_ann_bits(
                            *w, x0[:n].contiguous(), off[:n],
                            n_steps=n_steps, activation=act, **kw)
                        e = max(max_abs_err(torch, words_k,
                                            words_p[:, :n].contiguous()
                                            .view(torch.uint32)),
                                max_abs_err(torch, state_k, state_p[:n]))
                        check(e == 0.0, f"{name} != plain ({tag}, {system}, "
                                        f"{act}, {n} lanes)")
                        e_all = max(e_all, e)
                    if relu_words is None:
                        relu_words = words_p
                    else:
                        check(not torch.equal(words_p, relu_words),
                              f"{system} {unit} {tag} {act}: words equal "
                              f"relu's")
                    print(f"check {'bf16x2' if unit == 'vpu' else 'mxu x2'} "
                          f"{system} {tag} {act} lanes {counts} "
                          f"steps={n_steps}: {name} max_abs_err={e_all}")
                    errs[(name, tag)] = max(errs.get((name, tag), 0.0),
                                            e_all)
    t0 = time.perf_counter()
    check_lattice_gang_x2(torch, device, errs)
    t1 = time.perf_counter()
    check_lattice_traj_x2(torch, device, errs)
    t2 = time.perf_counter()
    check_mxu_gang_x2(torch, device, errs)
    t3 = time.perf_counter()
    check_traj_x2(torch, device, errs)
    t4 = time.perf_counter()
    check_scalar_gangs(torch, device, errs)
    print(f"bf16x2 lattice K3/K4 checks {t1 - t0:.1f} s, lattice K2 "
          f"{t2 - t1:.1f} s, two-lane mxu K3 {t3 - t2:.1f} s, scalar bf16 "
          f"and mxu K2 {t4 - t3:.1f} s, scalar K3/K4 (bf16, f32) "
          f"{time.perf_counter() - t4:.1f} s")
    if log:
        for kernel in ("bits_kernel", "lattice_bits_kernel",
                       "bf16x2_bits_kernel", "bf16x2_traj_kernel",
                       "bf16x2_gang_bits_kernel",
                       "bf16x2_gang_stacked_kernel",
                       "f32_gang_bits_kernel", "f32_gang_stacked_kernel",
                       "bf16x2_lattice_bits_kernel",
                       "bf16x2_lattice_traj_kernel",
                       "bf16x2_lattice_gang_bits_kernel",
                       "bf16x2_lattice_gang_stacked_kernel",
                       "mxu_x2_bits_kernel", "bf16x2_mxu_bits_kernel",
                       "mxu_x2_traj_kernel", "bf16x2_mxu_traj_kernel",
                       "mxu_x2_gang_bits_kernel",
                       "bf16x2_mxu_gang_bits_kernel"):
            print(f"ptxas: {kernel_registers(log, kernel)}")


def check_lattice_gang_x2(torch, device, errs) -> None:
    """The bf16 lattice K3 and K4 on the bf16x2 row loop bitwise their
    plain versions (LATTICE_GANG_X2_CHECKS), relu, tanh and sigmoid: the
    words each block or core computed, and the final states."""
    from repro_torch.kernels import chaotic_ann, ref

    rng = np.random.default_rng(24)
    core_map = np.array(LATTICE_GANG_X2_CORE_MAP)
    n_max = max(LATTICE_GANG_X2_LANES)
    for system, s_blocks, n_steps in LATTICE_GANG_X2_CHECKS:
        w, lattice = lattice_gang_weights(torch, device, system)
        w3 = [a[:3] for a in w]
        i_dim, n_rows = w[0].shape[1], n_steps // 2
        rows = np.minimum(LATTICE_GANG_X2_K3_ROWS, n_rows)
        srows = np.minimum(LATTICE_GANG_X2_K4_ROWS, n_rows)
        core_rows = torch.as_tensor(srows, device=device)[:, None]
        xs = torch.as_tensor(rng.uniform(-0.9, 0.9, (3, n_max, i_dim)),
                             dtype=torch.float32, device=device).to(
                                 torch.bfloat16)
        offs_np = rng.integers(0, 1 << 32, (3, n_max), dtype=np.int64)
        offs_np[:, :2] = (1 << 32) - 1, (1 << 32) - 3      # wrap mid-run
        offs = torch.as_tensor(offs_np, device=device)
        for act in ("relu", "tanh", "sigmoid"):
            e3 = 0.0
            for s_block in s_blocks:
                n_lanes = len(core_map) * s_block
                x0 = torch.as_tensor(
                    rng.uniform(-0.9, 0.9, (n_lanes, i_dim)),
                    dtype=torch.float32, device=device).to(torch.bfloat16)
                off_np = rng.integers(0, 1 << 32, n_lanes, dtype=np.int64)
                off_np[:2] = (1 << 32) - 1, (1 << 32) - 3
                off = torch.as_tensor(off_np, device=device)
                words_k, state_k = chaotic_ann.chaotic_ann_gang_bits(
                    *w, x0, core_map, off, rows, n_steps=n_steps,
                    s_block=s_block, t_block=n_steps, unroll=1,
                    lattice=lattice, activation=act)
                words_p, state_p = ref.chaotic_ann_gang_bits_ref(
                    *w, x0, core_map, n_steps, off, rows, act, lattice)
                lane_rows = torch.as_tensor(np.repeat(rows, s_block),
                                            device=device)
                e = max(masked_err(torch, words_k, words_p, lane_rows),
                        max_abs_err(torch, state_k, state_p))
                check(e == 0.0, f"bf16x2_lattice_gang_bits_kernel != plain "
                                f"({system}, {act}, s_block {s_block})")
                e3 = max(e3, e)
            words_p, state_p = ref.chaotic_ann_gang_stacked_ref(
                *w3, xs, n_steps, offs, srows, act, lattice)
            e4 = 0.0
            for n in LATTICE_GANG_X2_LANES:
                words_k, state_k = chaotic_ann.chaotic_ann_gang_stacked(
                    *w3, xs[:, :n].contiguous(), offs[:, :n].contiguous(),
                    srows, n_steps=n_steps, lattice=lattice, activation=act)
                e = max(masked_err(torch, words_k, words_p[:, :, :n],
                                   core_rows),
                        max_abs_err(torch, state_k, state_p[:, :n]))
                check(e == 0.0, f"bf16x2_lattice_gang_stacked_kernel != "
                                f"plain ({system}, {act}, {n} lanes)")
                e4 = max(e4, e)
            print(f"check bf16x2 lattice gang {system} bf16 {act}: "
                  f"chaotic_ann_lattice_gang_bits (6 blocks x s_block "
                  f"{s_blocks}, rows {rows.tolist()}, steps={n_steps}) "
                  f"max_abs_err={e3}; chaotic_ann_lattice_gang_stacked (3 "
                  f"cores x {LATTICE_GANG_X2_LANES} lanes, rows "
                  f"{srows.tolist()}) max_abs_err={e4}")
            for name, e in (("chaotic_ann_lattice_gang_bits", e3),
                            ("chaotic_ann_lattice_gang_stacked", e4)):
                errs[(name, "bf16")] = max(errs.get((name, "bf16"), 0.0), e)


def check_scalar_gangs(torch, device, errs) -> None:
    """The scalar K3 and K4 bitwise their plain versions (GANG_X2_CHECKS),
    relu, tanh and sigmoid, bf16 on the bf16x2 row loop and f32 on the
    f32 row loop: the words each block or core computed, and the final
    states."""
    from repro_torch.kernels import chaotic_ann, ref

    rng = np.random.default_rng(27)
    n_blocks = len(LATTICE_GANG_X2_CORE_MAP)
    n_max = max(GANG_X2_LANES)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        names = BF16X2_GANG_KERNELS if tag == "bf16" else F32_GANG_KERNELS
        for shape, s_blocks, n_steps in GANG_X2_CHECKS:
            w = gang_weights(torch, device, shape)
            n_cores, i_dim = w[0].shape[:2]
            w3 = [a[np.arange(3) % n_cores] for a in w]
            core_map = np.array(LATTICE_GANG_X2_CORE_MAP) % n_cores
            rows = np.minimum(LATTICE_GANG_X2_K3_ROWS, n_steps // 2)
            srows = np.minimum(LATTICE_GANG_X2_K4_ROWS, n_steps // 2)
            core_rows = torch.as_tensor(srows, device=device)[:, None]
            s_max = max(s_blocks)
            x0 = torch.as_tensor(
                rng.uniform(-0.9, 0.9, (n_blocks, s_max, i_dim)),
                dtype=torch.float32, device=device).to(dtype)
            off_np = rng.integers(0, 1 << 32, (n_blocks, s_max),
                                  dtype=np.int64)
            off_np[:, :2] = (1 << 32) - 1, (1 << 32) - 3      # wrap mid-run
            off = torch.as_tensor(off_np, device=device)
            xs = torch.as_tensor(rng.uniform(-0.9, 0.9, (3, n_max, i_dim)),
                                 dtype=torch.float32, device=device).to(dtype)
            offs_np = rng.integers(0, 1 << 32, (3, n_max), dtype=np.int64)
            offs_np[:, :2] = (1 << 32) - 1, (1 << 32) - 3
            offs = torch.as_tensor(offs_np, device=device)
            for act in ("relu", "tanh", "sigmoid"):
                words_p, state_p = ref.chaotic_ann_gang_bits_ref(
                    *w, x0.reshape(-1, i_dim), core_map, n_steps,
                    off.reshape(-1), rows, act)
                words_p = words_p.view(torch.int32).reshape(-1, n_blocks,
                                                            s_max)
                state_p = state_p.reshape(n_blocks, s_max, i_dim)
                e3 = 0.0
                for s_block in s_blocks:
                    words_k, state_k = chaotic_ann.chaotic_ann_gang_bits(
                        *w, x0[:, :s_block].reshape(-1, i_dim), core_map,
                        off[:, :s_block].reshape(-1), rows, n_steps=n_steps,
                        s_block=s_block, t_block=n_steps, unroll=1,
                        activation=act)
                    lane_rows = torch.as_tensor(np.repeat(rows, s_block),
                                                device=device)
                    want = (words_p[:, :, :s_block]
                            .reshape(-1, n_blocks * s_block)
                            .contiguous().view(torch.uint32))
                    e = max(masked_err(torch, words_k, want, lane_rows),
                            max_abs_err(torch, state_k, state_p[:, :s_block]
                                        .reshape(-1, i_dim)))
                    check(e == 0.0, f"{names['chaotic_ann_gang_bits']} != "
                                    f"plain ({shape}, {act}, s_block "
                                    f"{s_block})")
                    e3 = max(e3, e)
                words_p, state_p = ref.chaotic_ann_gang_stacked_ref(
                    *w3, xs, n_steps, offs, srows, act)
                e4 = 0.0
                for n in GANG_X2_LANES:
                    words_k, state_k = chaotic_ann.chaotic_ann_gang_stacked(
                        *w3, xs[:, :n].contiguous(), offs[:, :n].contiguous(),
                        srows, n_steps=n_steps, activation=act)
                    e = max(masked_err(torch, words_k, words_p[:, :, :n],
                                       core_rows),
                            max_abs_err(torch, state_k, state_p[:, :n]))
                    check(e == 0.0, f"{names['chaotic_ann_gang_stacked']} "
                                    f"!= plain ({shape}, {act}, {n} lanes)")
                    e4 = max(e4, e)
                print(f"check scalar gang {shape} {tag} {act}: "
                      f"chaotic_ann_gang_bits ({n_blocks} blocks of "
                      f"{n_cores} cores x s_block {s_blocks}, rows "
                      f"{rows.tolist()}, steps={n_steps}) max_abs_err={e3}; "
                      f"chaotic_ann_gang_stacked (3 cores x {GANG_X2_LANES} "
                      f"lanes, rows {srows.tolist()}) max_abs_err={e4}")
                for name, e in (("chaotic_ann_gang_bits", e3),
                                ("chaotic_ann_gang_stacked", e4)):
                    key = (name, tag) if act == "relu" else (name, act, tag)
                    errs[key] = max(errs.get(key, 0.0), e)


def check_lattice_traj_x2(torch, device, errs) -> None:
    """The bf16 lattice K2 on the bf16x2 step with staged 16-byte stores
    bitwise its plain version (LATTICE_TRAJ_X2_CHECKS), relu, tanh and
    sigmoid: the whole trajectory of every lane count."""
    from repro_torch.core.ann import lattice_meta_tuple, params_from_numpy
    from repro_torch.kernels import chaotic_ann, ref
    from repro_torch.prng.stream import default_params

    rng = np.random.default_rng(25)
    name = "chaotic_ann_lattice_traj"
    for system, counts, n_steps in LATTICE_TRAJ_X2_CHECKS:
        p = params_from_numpy(default_params(system=system), device=device)
        w = (p["w1"], p["b1"], p["w2"], p["b2"])
        lattice = lattice_meta_tuple(p["lattice_meta"])
        x0 = torch.as_tensor(rng.uniform(-0.9, 0.9, (max(counts),
                                                     w[0].shape[0])),
                             dtype=torch.float32, device=device).to(
                                 torch.bfloat16)
        for act in ("relu", "tanh", "sigmoid"):
            traj_p = ref.chaotic_ann_ref(*w, x0, n_steps, act, lattice)
            e_all = 0.0
            for n in counts:
                traj_k = chaotic_ann.chaotic_ann_traj(
                    *w, x0[:n].contiguous(), n_steps=n_steps,
                    activation=act, lattice=lattice)
                e = max_abs_err(torch, traj_k, traj_p[:, :n].contiguous())
                check(e == 0.0, f"bf16x2_lattice_traj_kernel != plain "
                                f"({system}, {act}, {n} lanes)")
                e_all = max(e_all, e)
            print(f"check bf16x2 lattice traj {system} bf16 {act} lanes "
                  f"{counts} steps={n_steps}: {name} max_abs_err={e_all}")
            key = (name, "bf16") if act == "relu" else (name, act, "bf16")
            errs[key] = max(errs.get(key, 0.0), e_all)


def check_mxu_gang_x2(torch, device, errs) -> None:
    """The mxu K3 on the two-lane row loop bitwise its plain version
    (MXU_GANG_X2_CHECKS), f32 and bf16, relu, tanh and sigmoid: the words
    each block computed, and the final states."""
    from repro_torch.kernels import chaotic_ann, ref

    rng = np.random.default_rng(26)
    name = "chaotic_ann_mxu_gang_bits"
    n_blocks = len(LATTICE_GANG_X2_CORE_MAP)
    for shape, s_blocks, n_steps, n_cores in MXU_GANG_X2_CHECKS:
        w, lattice, cpl = mxu_gang_operands(torch, device, shape)
        w = [a[:n_cores] for a in w]
        core_map = np.array(LATTICE_GANG_X2_CORE_MAP) % n_cores
        rows = np.minimum(LATTICE_GANG_X2_K3_ROWS, n_steps // 2)
        s_max, i_dim = max(s_blocks), w[0].shape[1]
        x0_np = rng.uniform(-0.9, 0.9, (n_blocks, s_max, i_dim))
        off_np = rng.integers(0, 1 << 32, (n_blocks, s_max), dtype=np.int64)
        off_np[:, :2] = (1 << 32) - 1, (1 << 32) - 3      # wrap mid-run
        kw = dict(lattice=lattice, compute_unit="mxu", coupling=cpl)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            for act in ("relu", "tanh", "sigmoid"):
                x0 = torch.as_tensor(x0_np, dtype=torch.float32,
                                     device=device).to(dtype)
                off = torch.as_tensor(off_np, device=device)
                words_p, state_p = ref.chaotic_ann_gang_bits_ref(
                    *w, x0.reshape(-1, i_dim), core_map, n_steps,
                    off.reshape(-1), rows, act, **kw)
                words_p = words_p.view(torch.int32).reshape(-1, n_blocks,
                                                            s_max)
                state_p = state_p.reshape(n_blocks, s_max, i_dim)
                e_all = 0.0
                for s_block in s_blocks:
                    words_k, state_k = chaotic_ann.chaotic_ann_gang_bits(
                        *w, x0[:, :s_block].reshape(-1, i_dim), core_map,
                        off[:, :s_block].reshape(-1), rows, n_steps=n_steps,
                        s_block=s_block, t_block=n_steps, unroll=1,
                        activation=act, **kw)
                    lane_rows = torch.as_tensor(np.repeat(rows, s_block),
                                                device=device)
                    want = (words_p[:, :, :s_block].reshape(-1,
                                                            n_blocks * s_block)
                            .contiguous().view(torch.uint32))
                    e = max(masked_err(torch, words_k, want, lane_rows),
                            max_abs_err(torch, state_k, state_p[:, :s_block]
                                        .reshape(-1, i_dim)))
                    check(e == 0.0, f"two-lane mxu K3 != plain ({shape}, "
                                    f"{tag}, {act}, s_block {s_block})")
                    e_all = max(e_all, e)
                print(f"check mxu x2 gang {shape} {tag} {act}: {name} "
                      f"({n_blocks} blocks of {n_cores} cores x s_block "
                      f"{s_blocks}, rows {rows.tolist()}, steps={n_steps}) "
                      f"max_abs_err={e_all}")
                key = (name, tag) if act == "relu" else (name, act, tag)
                errs[key] = max(errs.get(key, 0.0), e_all)


def check_traj_x2(torch, device, errs) -> None:
    """The scalar bf16 K2 on the bf16x2 step (TRAJ_X2_CHECKS) and the
    two-lane mxu K2 in f32 and bf16 (MXU_TRAJ_X2_CHECKS), both with staged
    16-byte stores, bitwise their plain versions, relu, tanh and sigmoid:
    the whole trajectory of every lane count."""
    from repro_torch.core.ann import lattice_meta_tuple, params_from_numpy
    from repro_torch.kernels import chaotic_ann, ref
    from repro_torch.prng.stream import default_params

    rng = np.random.default_rng(26)
    both = ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
    for unit, checks, dtypes in (("vpu", TRAJ_X2_CHECKS, both[1:]),
                                 ("mxu", MXU_TRAJ_X2_CHECKS, both)):
        for system, counts, n_steps in checks:
            p = params_from_numpy(default_params(system=system),
                                  device=device)
            w = (p["w1"], p["b1"], p["w2"], p["b2"])
            lattice = (lattice_meta_tuple(p["lattice_meta"])
                       if "lattice_meta" in p else None)
            kw = dict(lattice=lattice, compute_unit=unit, coupling=(
                p["coupling"] if unit == "mxu" and lattice else None))
            x0_f = torch.as_tensor(rng.uniform(-0.9, 0.9, (max(counts),
                                                           w[0].shape[0])),
                                   dtype=torch.float32, device=device)
            name = kernel_names(lattice, unit)[1]
            for dtype, tag in dtypes:
                x0 = x0_f.to(dtype)
                for act in ("relu", "tanh", "sigmoid"):
                    traj_p = ref.chaotic_ann_ref(*w, x0, n_steps, act, **kw)
                    e_all = 0.0
                    for n in counts:
                        traj_k = chaotic_ann.chaotic_ann_traj(
                            *w, x0[:n].contiguous(), n_steps=n_steps,
                            activation=act, **kw)
                        e = max_abs_err(torch, traj_k,
                                        traj_p[:, :n].contiguous())
                        check(e == 0.0, f"{K2_X2_KERNELS[(unit, tag)]} != "
                                        f"plain ({system}, {act}, {n} lanes)")
                        e_all = max(e_all, e)
                    print(f"check {unit} K2 x2 {system} {tag} {act} lanes "
                          f"{counts} steps={n_steps}: {name} "
                          f"max_abs_err={e_all}")
                    key = (name, tag) if act == "relu" else (name, act, tag)
                    errs[key] = max(errs.get(key, 0.0), e_all)


def mirrored_share(n_nodes: int, s_block: int) -> float:
    """The share of lane halves a two-lane K3 launch computes as mirrors:
    a block of s_block lanes takes ceil(s_block / span) CTAs of span = 2
    lanes a lane slot, the CTA's 128 / slot_width(n_nodes) slots or one
    slot where it fills the CTA (``GangCta``)."""
    from repro_torch.kernels import chaotic_ann
    span = 2 * chaotic_ann.gang_lane_granularity(n_nodes)
    return 1.0 - s_block / (-(-s_block // span) * span)


# the TPU kernel each wrapper replaces (its lattice form too)
REPLACES = {"chaotic_ann_bits": "src/repro/kernels/chaotic_ann.py:441",
            "chaotic_ann_traj": "src/repro/kernels/chaotic_ann.py:254",
            "chaotic_ann_gang_bits": "src/repro/kernels/chaotic_ann.py:630",
            "chaotic_ann_gang_stacked": "src/repro/kernels/chaotic_ann.py:894",
            "chaotic_ann_lattice_gang_bits":
                "src/repro/kernels/chaotic_ann.py:630",
            "chaotic_ann_lattice_gang_stacked":
                "src/repro/kernels/chaotic_ann.py:894",
            "chaotic_ann_mxu_gang_bits":
                "src/repro/kernels/chaotic_ann.py:630"}
# each served (system, unit)'s (served path, unfused path): the served
# path runs K1 only, the unfused path K2 only
PATHS = {("chen", "vpu"): ("served", "unfused"),
         (LATTICE, "vpu"): ("lattice-served", "lattice-unfused"),
         (LATTICE, "mxu"): ("mxu-served", "mxu-unfused")}
# the CUDA kernels behind the mxu K1 and K3 wrappers (two lanes a thread),
# by dtype
MXU_K1_KERNELS = {"f32": "mxu_x2_bits_kernel",
                  "bf16": "bf16x2_mxu_bits_kernel"}
MXU_K3_KERNELS = {"f32": "mxu_x2_gang_bits_kernel",
                  "bf16": "bf16x2_mxu_gang_bits_kernel"}
# the CUDA kernels behind the two-lane K2 wrappers: the mxu K2 in both
# dtypes, the scalar vpu K2 in bf16 (f32 keeps the one-lane traj_kernel)
K2_X2_KERNELS = {("mxu", "f32"): "mxu_x2_traj_kernel",
                 ("mxu", "bf16"): "bf16x2_mxu_traj_kernel",
                 ("vpu", "bf16"): "bf16x2_traj_kernel"}
# the CUDA kernels behind the bf16 lattice K1-K4 wrappers (the bf16x2 step,
# two lanes a node thread); f32 keeps the one-lane forms
BF16X2_LATTICE_KERNELS = {
    "chaotic_ann_lattice_bits": "bf16x2_lattice_bits_kernel",
    "chaotic_ann_lattice_traj": "bf16x2_lattice_traj_kernel",
    "chaotic_ann_lattice_gang_bits": "bf16x2_lattice_gang_bits_kernel",
    "chaotic_ann_lattice_gang_stacked": "bf16x2_lattice_gang_stacked_kernel"}
# the CUDA kernels behind the bf16 scalar K3 and K4 wrappers (the bf16x2 K1's
# row loop, two lanes a thread), and the f32 ones (the f32 K1's row loop, a
# thread a lane)
BF16X2_GANG_KERNELS = {
    "chaotic_ann_gang_bits": "bf16x2_gang_bits_kernel",
    "chaotic_ann_gang_stacked": "bf16x2_gang_stacked_kernel"}
F32_GANG_KERNELS = {
    "chaotic_ann_gang_bits": "f32_gang_bits_kernel",
    "chaotic_ann_gang_stacked": "f32_gang_stacked_kernel"}
# the scalar K3 and K4 wrappers, which pass the callers' int64 offsets to
# their kernels in both dtypes (the lattice and mxu ones pass uint32)
SCALAR_GANG_WRAPPERS = tuple(F32_GANG_KERNELS)
# both gangs' bf16 kernels, scalar and lattice
BF16X2_GANG_X2_KERNELS = {**BF16X2_LATTICE_KERNELS, **BF16X2_GANG_KERNELS}
KERNELS = ("chaotic_ann_bits", "chaotic_ann_traj", "chaotic_ann_gang_bits",
           "chaotic_ann_gang_stacked", "chaotic_ann_lattice_bits",
           "chaotic_ann_lattice_traj", "chaotic_ann_mxu_bits",
           "chaotic_ann_mxu_traj", "chaotic_ann_lattice_gang_bits",
           "chaotic_ann_lattice_gang_stacked", "chaotic_ann_mxu_gang_bits")


def read_launches(chaotic_ann) -> dict:
    return {name: getattr(chaotic_ann, name).launches for name in KERNELS}


def zero_launches(chaotic_ann) -> None:
    for name in KERNELS:
        getattr(chaotic_ann, name).launches = 0


def phase_served(torch, device, dtype, tag, card, system, n_words, seed0,
                 errs, unit="vpu"):
    """One served path at full width, then its unfused path: ``PRNGService``
    on ``system`` (the scalar chen; the chen@ring32 lattice on an explicit
    vpu config, or with ``unit="mxu"`` on no config, the JAX package's
    default stream), 512 clients x 128 lanes, register and three flushes
    of ``n_words`` words a client; then K1 and K2 against one plain run at
    the flush's own shape, bitwise.  Returns ({path: launch counts},
    timings, served words for the NIST phase)."""
    from repro_torch.core.ann import lattice_meta_tuple
    from repro_torch.core.dse import default_config
    from repro_torch.kernels import chaotic_ann, ops, ref
    from repro_torch.prng.stream import (ChaoticPRNG, _round_rows,
                                         trained_oscillator)
    from repro_torch.serve.prng_service import PRNGService

    params_np = trained_oscillator(system)   # a lattice derives from chen's
    L = LANES_PER_CLIENT
    names = [f"client{i:03d}" for i in range(N_CLIENTS)]
    served_path, unfused_path = PATHS[(system, unit)]
    lattice = (lattice_meta_tuple(params_np["lattice_meta"])
               if "lattice_meta" in params_np else None)
    config = None if lattice is None or unit == "mxu" else default_config(
        *params_np["w1"].shape, dtype, n_nodes=lattice[0])

    def make_service():
        return PRNGService(params_np, lanes_per_client=L, dtype=dtype,
                           config=config, device=device)

    zero_launches(chaotic_ann)
    t0 = time.perf_counter()
    svc = make_service()
    for i, name in enumerate(names):
        svc.register(name, seed=seed0 + i)
    torch.cuda.synchronize()
    t_register = time.perf_counter() - t0
    bits_name, traj_name = kernel_names(lattice, unit)
    print(f"{served_path} {tag}: config {'given' if config else 'resolved'}"
          f" {svc.config}")
    check(svc.config.compute_unit == unit
          and svc.config.n_nodes == (1 if lattice is None else lattice[0]),
          f"{system} {tag}: config {svc.config}")

    x_before = svc.pool_x.clone()            # every client at word row 0
    for name in names:
        svc.request(name, n_words)
    t0 = time.perf_counter()
    out1 = svc.flush()
    torch.cuda.synchronize()
    t_flush1 = time.perf_counter() - t0
    check(svc.launches == 1, f"{system} {tag}: one flush must be one launch")
    check(all(out1[n].size == n_words for n in names),
          f"{system} {tag}: flush sizes")

    snap = svc.snapshot()
    for name in names:
        svc.request(name, n_words)
    t0 = time.perf_counter()
    out2 = svc.flush()
    torch.cuda.synchronize()
    t_flush2 = time.perf_counter() - t0

    # where a flush's wall time goes: plan, launch + copy to host, absorb
    for name in names:
        svc.request(name, n_words)
    t0 = time.perf_counter()
    n_need, offsets = svc.prepare_rows()
    n_rows = _round_rows(n_need, svc.config.t_block)
    t1 = time.perf_counter()
    words, new_x = svc._launch(n_rows, offsets)
    t2 = time.perf_counter()
    svc.absorb(words, new_x, n_rows)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {served_path: read_launches(chaotic_ann)}
    got = launches[served_path]
    check(got[bits_name] == N_CLIENTS + 3 and sum(got.values()) == got[bits_name],
          f"{system} {tag}: the served path must launch {bits_name} once per "
          f"burn-in and per flush, and nothing else; got {got}")
    split = {"plan_ms": (t1 - t0) * 1e3, "launch_and_copy_ms": (t2 - t1) * 1e3,
             "absorb_ms": (t3 - t2) * 1e3}
    pool_mb = svc.pool_x.numel() * svc.pool_x.element_size() / 1e6
    slab_mb = words.nbytes / 1e6

    # snapshot/restore continues every stream bit-exactly
    svc2 = make_service()
    svc2.restore(snap)
    for name in names:
        svc2.request(name, n_words)
    out2r = svc2.flush()
    check(all(np.array_equal(out2[n], out2r[n]) for n in names),
          f"{system} {tag}: snapshot/restore continuation differs")

    # a standalone engine, drawn in other chunks, gives the same words
    eng = ChaoticPRNG(params_np, n_streams=L, config=svc.config, dtype=dtype,
                      device=device)
    for i in (0, 1, N_CLIENTS - 1):
        state = eng.init(seed=seed0 + i)
        parts = []
        first, second = n_words // 65, n_words // 2 + 7     # odd chunks
        for n in (first, second, 2 * n_words - first - second):
            w, state = eng.next_words(state, n)
            parts.append(w)
        check(np.array_equal(np.concatenate(parts),
                             np.concatenate([out1[names[i]], out2[names[i]]])),
              f"{system} {tag}: chunked standalone stream differs for "
              f"{names[i]}")

    # the unfused path (trajectory kernel + packing) gives the same words
    n_steps = 2 * (n_words // L)
    zero_launches(chaotic_ann)
    traj = ops.chaotic_trajectory(svc.params, x_before, n_steps,
                                  config=svc.config)
    slab = ops.pack_words(traj, 0).cpu().numpy()
    launches[unfused_path] = read_launches(chaotic_ann)
    del traj
    got = launches[unfused_path]
    check(got[traj_name] == 1 and sum(got.values()) == 1,
          f"{system} {tag}: the unfused path must launch {traj_name} once, "
          f"got {got}")
    check(all(np.array_equal(slab[:, i * L:(i + 1) * L].reshape(-1), out1[n])
              for i, n in enumerate(names)),
          f"{system} {tag}: unfused pipeline differs from the fused service")
    # every lane shares the row counter here, so lanes whose oscillators
    # have merged emit equal words: distinct words per row count them
    distinct = [len(np.unique(slab[r])) for r in (0, len(slab) - 1)]
    print(f"{served_path} path {tag}: {system}, {N_CLIENTS} clients x {L} "
          f"lanes, {N_CLIENTS * n_words} words per flush ({n_rows} rows); "
          f"pool {pool_mb:.1f} MB, word slab {slab_mb:.1f} MB; launches "
          f"{ {p: {k: v for k, v in c.items() if v} for p, c in launches.items()} }; "
          f"register {t_register:.3f} s; flush wall {t_flush1 * 1e3:.1f} ms "
          f"then {t_flush2 * 1e3:.1f} ms ({N_CLIENTS * n_words / t_flush2:.4g}"
          f" words/s); third flush split "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f"; distinct words of {x_before.shape[0]} lanes in row 0 "
          f"{distinct[0]}, in row {len(slab) - 1} {distinct[1]}; card {card}")

    # device times at the flush shape (not counted as path launches)
    w = [svc.params[k] for k in ("w1", "b1", "w2", "b2")]
    kw = dict(lattice=lattice, compute_unit=unit, coupling=(
        svc.params["coupling"] if unit == "mxu" and lattice else None))
    x, s_pool = x_before, x_before.shape[0]
    off = torch.zeros(s_pool, dtype=torch.int64, device=device)
    i_dim, h_dim = w[0].shape
    item = x.element_size()
    n_out = n_steps // 2 * s_pool
    mxu_step = (mxu_step_flops(i_dim, h_dim, lattice) if unit == "mxu"
                 else None)    # the chains accumulate in f32, in both dtypes
    ops_step = (sum(mxu_step) if unit == "mxu"
                else step_flops(i_dim, h_dim) if lattice is None
                else lattice_step_flops(lattice, h_dim))
    t = {
        "bits_ms": cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_bits(
            *w, x, off, n_steps=n_steps, **kw), reps=5, warmup=2),
        "traj_ms": cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_traj(
            *w, x, n_steps=n_steps, **kw), reps=3, warmup=1),
        "unfused_ms": cuda_ms(torch, lambda: ops.pack_words(
            chaotic_ann.chaotic_ann_traj(*w, x, n_steps=n_steps, **kw), off),
            reps=2, warmup=1),
    }
    # one plain run (the kernels' arithmetic op by op, the lattice's
    # densely), timed, held bitwise against K2; plain K1 is that run
    # packed by ``ops.pack_words`` (its time: the run's plus the packing's).
    # On the mxu unit the run covers the first MXU_TIME_PLAIN_LANES lanes
    # (lanes are independent; the f32 FMA chains took 26.7 s at all
    # 65,536 on the H100 machine)
    n_plain = MXU_TIME_PLAIN_LANES if unit == "mxu" else s_pool
    traj_p, t["traj_plain_ms"] = timed_once(
        torch, lambda: ref.chaotic_ann_ref(*w, x[:n_plain], n_steps, **kw))
    words_p, pack_ms = timed_once(
        torch, lambda: ops.pack_words(traj_p, off[:n_plain]))
    t["bits_plain_ms"] = t["traj_plain_ms"] + pack_ms
    t["plain_lanes"] = n_plain
    words_k, state_k = chaotic_ann.chaotic_ann_bits(*w, x, off,
                                                    n_steps=n_steps, **kw)
    e_bits = max(max_abs_err(torch, words_k.view(torch.int32)[:, :n_plain]
                             .view(torch.uint32), words_p),
                 max_abs_err(torch, state_k[:n_plain], traj_p[-1]))
    del words_p, words_k, state_k
    traj_k = chaotic_ann.chaotic_ann_traj(*w, x, n_steps=n_steps, **kw)
    e_traj = max_abs_err(torch, traj_k[:, :n_plain], traj_p)
    del traj_p, traj_k
    print(f"check {system} {unit} {tag} S={s_pool} steps={n_steps} (the "
          f"flush's shape; the plain run on the first {n_plain} lanes): "
          f"{bits_name} max_abs_err={e_bits} {traj_name} "
          f"max_abs_err={e_traj}")
    check(e_bits == 0.0, f"{bits_name} != plain ({system}, {tag}, flush shape)")
    check(e_traj == 0.0, f"{traj_name} != plain ({system}, {tag}, flush shape)")
    for name, e in ((bits_name, e_bits), (traj_name, e_traj)):
        errs[(name, tag)] = max(errs.get((name, tag), 0.0), e)
    weight_bytes = (2 * i_dim * h_dim + h_dim + i_dim) * item
    if kw["coupling"] is not None:
        weight_bytes += i_dim * i_dim * item
    bits_bytes = (2 * s_pool * i_dim * item + s_pool * 4 + weight_bytes
                  + n_out * 4)
    traj_bytes = (s_pool * i_dim * item + weight_bytes
                  + n_steps * s_pool * i_dim * item)
    if unit == "mxu":
        t["bits_bound"] = mxu_bound(n_out * 2, mxu_step, bits_bytes, tag)
        t["traj_bound"] = mxu_bound(n_steps * s_pool, mxu_step, traj_bytes,
                                    tag)
    else:
        t["bits_bound"] = bound(n_out * 2 * ops_step, bits_bytes, tag)
        t["traj_bound"] = bound(n_steps * s_pool * ops_step, traj_bytes, tag)
    t["flush_s"] = t_flush2
    dense = ""
    if unit == "mxu":     # a count of the dense work, not a bound
        dense_ms = (n_out * 2 * mxu_dense_flops(i_dim, h_dim, lattice)
                    / PEAK_OPS["mxu"] * 1e3)
        dense = (f"; the dense dots' work, zero terms too, is {dense_ms:.4f}"
                 f" ms at the mxu rate: not a bound, the kernel skips "
                 f"those terms")
    ops_text = (f"{mxu_step[0]} FMA flops + {mxu_step[1]} {tag} adds + "
                f"{mxu_step[2]} f32" if unit == "mxu" else f"{ops_step}")
    print(f"device times {system} {unit} {tag} (S={s_pool}, n_steps={n_steps},"
          f" {ops_text} ops a step): {bits_name} {t['bits_ms']:.4f} ms "
          f"({n_out / t['bits_ms'] * 1e3:.4g} words/s, bound "
          f"{t['bits_bound'][0]:.4f} ms by {t['bits_bound'][1]}{dense}); "
          f"plain on {n_plain} lanes {t['bits_plain_ms']:.1f} ms; "
          f"unfused traj+pack {t['unfused_ms']:.3f} ms; "
          f"{traj_name} {t['traj_ms']:.4f} ms (bound "
          f"{t['traj_bound'][0]:.4f} ms by {t['traj_bound'][1]}); "
          f"plain {t['traj_plain_ms']:.1f} ms; device busy "
          f"{t['bits_ms'] / (t_flush2 * 1e3):.2%} of the 2nd flush's wall; "
          f"card {card}")
    served = np.concatenate([out1[n] for n in names[:NIST_WORDS // n_words]])
    return launches, t, served


def kernel_rows(system, unit, tag, launches, t, errs):
    """The ``kernels`` line's rows of one served path's K1 and K2."""
    lattice = "@" in system
    rows = []
    for name, key, path in zip(kernel_names(lattice, unit), ("bits", "traj"),
                               PATHS[(system, unit)]):
        row = {
            "name": f"{name}/{tag}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chaotic_ann.cu",
            "replaces": REPLACES[f"chaotic_ann_{key}"], "path": path,
            "launches": launches[path][name],
            "max_abs_err": errs[(name, tag)],
            "ms": t[f"{key}_ms"], "plain_ms": t[f"{key}_plain_ms"],
            "bound_ms": t[f"{key}_bound"][0],
            "bound_by": t[f"{key}_bound"][1], "library_ms": None,
            "plain_lanes": t["plain_lanes"],
            "unfused_ms": t["unfused_ms"] if key == "bits" else None,
            "flush_wall_ms": t["flush_s"] * 1e3 if key == "bits" else None,
        }
        if unit == "mxu":
            row["form"] = (f"{system} mxu unit (the dot form, "
                           f"src/repro/kernels/chaotic_ann.py:154-161, with "
                           f"K5's coupling dot :148-152)")
            row["kernel"] = (MXU_K1_KERNELS[tag] if key == "bits"
                             else K2_X2_KERNELS[(unit, tag)])
        elif not lattice and key == "traj" and tag == "bf16":
            row["kernel"] = K2_X2_KERNELS[(unit, tag)]
        elif lattice:
            row["form"] = (f"{system} vpu lattice (K5, "
                           f"src/repro/kernels/chaotic_ann.py:61)")
            if tag == "bf16" and name in BF16X2_LATTICE_KERNELS:
                row["kernel"] = BF16X2_LATTICE_KERNELS[name]
        rows.append(row)
    return rows


def make_farm(torch, device, tag, gang=True, mesh=None, cost_model=None):
    """The committed farm: bf16 through ``from_generated``; f32 as the same
    solutions at dtype_bytes=4 through ``add_core``; every core on
    ``mesh`` when one is given, planned by ``cost_model``."""
    from repro_torch.core.dse import Candidate
    from repro_torch.serve.farm import OscillatorFarm
    if tag == "bf16":
        return OscillatorFarm.from_generated(
            FARM_DIR, gang=gang, profile=True, device=device,
            gang_cost_model=cost_model, mesh=mesh)
    farm = OscillatorFarm(gang=gang, profile=True, device=device,
                          gang_cost_model=cost_model)
    for name in sorted(p.name for p in FARM_DIR.iterdir()
                       if (p / "solution.json").exists()):
        sol = json.loads((FARM_DIR / name / "solution.json").read_text())
        cand = dataclasses.replace(Candidate(**sol["candidate"]),
                                   dtype_bytes=4)
        with np.load(FARM_DIR / name / "weights.npz") as npz:
            weights = dict(npz)
        farm.add_core(name, weights, config=cand, dtype=torch.float32,
                      activation=sol.get("activation", "relu"), mesh=mesh)
    return farm


def make_lattice_farm(device, dtype, gang=True, mesh=None):
    """The lattice farm: the four LATTICE_FARM cores on
    ``default_config(96, 256, dtype, n_nodes=32)`` beside the scalar chen
    on its own vpu config."""
    from repro_torch.core.dse import default_config
    from repro_torch.prng.stream import default_params
    from repro_torch.serve.farm import OscillatorFarm
    farm = OscillatorFarm(gang=gang, profile=True, device=device)
    for system in LATTICE_FARM:
        farm.add_core(system, default_params(system=system),
                      config=default_config(96, 256, dtype, n_nodes=32),
                      dtype=dtype, mesh=mesh)
    farm.add_core("chen", default_params(system="chen"),
                  config=default_config(3, 8, dtype), dtype=dtype, mesh=mesh)
    return farm


def make_mxu_farm(device, dtype, gang=True, mesh=None):
    """The mxu farm: the four LATTICE_FARM cores with NO config (the mxu
    unit) beside the four 3-8-3 registry nets on
    ``select_config(3, 8, s_total=128, unit="mxu")``."""
    from repro_torch.core.dse import select_config
    from repro_torch.prng.stream import default_params
    from repro_torch.serve.farm import OscillatorFarm
    scalar_cfg = select_config(3, 8, s_total=LANES_PER_CLIENT, dtype=dtype,
                               unit="mxu")
    farm = OscillatorFarm(gang=gang, profile=True, device=device)
    for system in LATTICE_FARM:
        farm.add_core(system, default_params(system=system), dtype=dtype,
                      mesh=mesh)
    for system in GANGS["3-8"]:
        farm.add_core(system, default_params(system=system),
                      config=scalar_cfg, dtype=dtype, mesh=mesh)
    return farm


def same_words(a, b) -> bool:
    return set(a) == set(b) and all(
        set(a[c]) == set(b[c]) and all(np.array_equal(a[c][k], b[c][k])
                                       for k in a[c]) for c in a)


def request_all(farms, words) -> None:
    """Queue ``words[core]`` words for every client of every core."""
    for f in farms:
        for core in f.cores:
            for name in f.services[core].clients:
                f.request(core, name, words[core])


def register_all(torch, farms, clients, seed0) -> float:
    """Register ``clients`` on every core of every farm (core k's client i
    seeded ``seed0 + 1000 * k + i``); returns the seconds per farm."""
    t0 = time.perf_counter()
    for f in farms:
        for k, core in enumerate(f.cores):
            for i, name in enumerate(clients):
                f.register(core, name, seed=seed0 + 1000 * k + i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / len(farms)


def launch_inputs(torch, device, svcs):
    """Each service's pool and its per-lane Weyl offsets, as the next
    flush will launch them (``prepare_rows`` has no side effect)."""
    pools = [s.pool_x.clone() for s in svcs]
    offsets = [torch.as_tensor(s.prepare_rows()[1].astype(np.int64),
                               device=device) for s in svcs]
    return pools, offsets


def counted_flush(torch, farm, solo, what, card):
    """Flush ``farm`` with the launch counters zeroed just before and read
    just after; print the flush's words, wall, profile split, decisions
    and launches; hold its words against ``solo`` (gang=False).  Returns
    (served words, kernel launches, planner decisions, plan layouts, farm
    launches, wall seconds)."""
    from repro_torch.kernels import chaotic_ann
    n0, dec0, prof0 = farm.launches, farm.plan_decisions, farm.profile_stats
    zero_launches(chaotic_ann)
    t0 = time.perf_counter()
    out = farm.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches(chaotic_ann)
    decisions = {k: v - dec0[k] for k, v in farm.plan_decisions.items()
                 if v != dec0[k]}
    prof = {k: (v - prof0[k]) * 1e3 for k, v in farm.profile_stats.items()
            if k != "flushes"}
    modes = sorted({p["mode"] for p in farm._sched._plans.values()})
    n_words = sum(w.size for c in out.values() for w in c.values())
    print(f"{what}: {n_words} words, wall {wall * 1e3:.1f} ms "
          f"({n_words / wall:.4g} words/s); profile ms "
          + ", ".join(f"{k} {v:.1f}" for k, v in prof.items())
          + f"; decisions {decisions}; plan layouts {modes}; farm launches "
          f"{farm.launches - n0}; kernel launches "
          f"{ {k: v for k, v in got.items() if v} }; card {card}")
    check(same_words(out, solo.flush()),
          f"{what}: gang words differ from gang=False")
    return out, got, decisions, modes, farm.launches - n0, wall


def phase_farm(torch, device, dtype, tag, card):
    """The farm path: three flushes, each held against a gang=False farm;
    returns ({flush: launch counts}, timings)."""
    from repro_torch.kernels import chaotic_ann, ref
    from repro_torch.serve.prng_service import PRNGService

    farm = make_farm(torch, device, tag)
    solo = make_farm(torch, device, tag, gang=False)
    cores = farm.cores
    clients = [f"c{i:03d}" for i in range(FARM_CLIENTS)]
    t_register = register_all(torch, (farm, solo), clients, 0)
    # a standalone service for two chen clients
    chen = farm.services["chen"]
    alone = PRNGService(chen.params, lanes_per_client=LANES_PER_CLIENT,
                        config=chen.config, dtype=dtype, device=device)
    for i, name in enumerate(clients[:2]):
        alone.register(name, seed=1000 * cores.index("chen") + i)

    hot = {c: HOT_WORDS if c == "chen" else COLD_WORDS for c in cores}
    flushes = (("F1", {c: FARM_WORDS for c in cores}), ("F2", hot),
               ("F3", {c: FARM_WORDS for c in cores}))
    launches, outs, snap = {}, {}, None
    for label, words in flushes:
        if label == "F3":                  # unequal pools: one more client
            for f in (farm, solo):
                f.register("lorenz", f"c{FARM_CLIENTS}", seed=99)
        request_all((farm, solo), words)
        if label == "F2":                  # requests pending
            snap = farm.snapshot()
        out, got, decisions, modes, n_launched, _ = counted_flush(
            torch, farm, solo, f"farm {tag} {label}", card)
        launches[label] = got
        check(got["chaotic_ann_mxu_gang_bits"] + got["chaotic_ann_mxu_bits"]
              == 0, f"farm {tag} {label}: an mxu kernel launched on the "
                    f"vpu farm ({got})")
        for name in clients[:2]:
            alone.request(name, words["chen"])
        mine = alone.flush()
        check(all(np.array_equal(mine[n], out["chen"][n])
                  for n in clients[:2]),
              f"farm {tag} {label}: chen differs from a standalone service")
        outs[label] = out
        if label == "F1":
            check(decisions == {"padded": 1} and modes == ["stacked"]
                  and got["chaotic_ann_gang_stacked"] == 1
                  and got["chaotic_ann_bits"] == 1
                  and got["chaotic_ann_gang_bits"] == 0
                  and n_launched == 2,
                  f"farm {tag} F1: expected one padded K4 launch and one K1"
                  f" launch, got {decisions} {got}")
        elif label == "F2":
            check("padded" not in decisions and got["chaotic_ann_gang_bits"]
                  + got["chaotic_ann_gang_stacked"] + got["chaotic_ann_bits"]
                  > 0, f"farm {tag} F2: expected ragged or split, got "
                       f"{decisions} {got}")
        else:
            check(decisions == {"padded": 1}
                  and got["chaotic_ann_gang_bits"] == 1
                  and got["chaotic_ann_gang_stacked"] == 0,
                  f"farm {tag} F3: expected one padded K3 launch, got "
                  f"{decisions} {got}")
    fresh = make_farm(torch, device, tag)
    fresh.restore(snap)
    check(same_words(outs["F2"], fresh.flush()),
          f"farm {tag}: F2 restored from a snapshot differs")
    print(f"farm {tag}: {len(cores)} cores x {FARM_CLIENTS} clients x "
          f"{LANES_PER_CLIENT} lanes; register {t_register:.3f} s per farm; "
          f"every flush bitwise equal to the gang=False farm, chen to a "
          f"standalone service, F2 to its snapshot restored")

    # device times at F1's and F2's shapes (not counted as farm launches)
    small = [c for c in cores if c != "hyperlorenz"]
    svcs = [farm.services[c] for c in small]
    w = [torch.stack([s.params[k] for s in svcs])
         for k in ("w1", "b1", "w2", "b2")]
    n_cores, i_dim, h_dim = w[0].shape
    s_pool = FARM_CLIENTS * LANES_PER_CLIENT
    x0s = torch.stack([s.pool_x[:s_pool] for s in svcs]).contiguous()
    x0c = x0s.reshape(n_cores * s_pool, i_dim)
    cfg = svcs[0].config
    s_block = cfg.s_block
    core_map = np.repeat(np.arange(n_cores), s_pool // s_block)
    offs = torch.zeros((n_cores, s_pool), dtype=torch.int64, device=device)
    offc = offs.reshape(-1)
    item = x0s.element_size()
    weight_bytes = n_cores * (2 * i_dim * h_dim + h_dim + i_dim) * item
    rows_f1 = FARM_WORDS // LANES_PER_CLIENT
    demand = [(HOT_WORDS if c == "chen" else COLD_WORDS) // LANES_PER_CLIENT
              for c in small]
    rows_f2 = max(demand)
    eff = chaotic_ann.gang_effective_rows(np.repeat(demand, s_pool // s_block),
                                          2 * rows_f2, cfg.t_block, cfg.unroll)

    def gang_bound(rows_per_lane_sum):
        # each input read once (x0, int64 offsets, weights, maps), each
        # output written once (the words computed, the state)
        n_bytes = (2 * n_cores * s_pool * i_dim * item + n_cores * s_pool * 8
                   + weight_bytes + rows_per_lane_sum * 4)
        return bound(rows_per_lane_sum * 2 * step_flops(i_dim, h_dim),
                     n_bytes, tag)

    t = {"rows_f2": rows_f2}
    steps_f1, steps_f2 = 2 * rows_f1, 2 * rows_f2
    t["k4_f1"] = cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_gang_stacked(
        *w, x0s, offs, n_steps=steps_f1), reps=10, warmup=2)
    t["k4_f1_plain"] = cuda_ms(torch, lambda: ref.chaotic_ann_gang_stacked_ref(
        *w, x0s, steps_f1, offs), reps=1, warmup=1)
    t["k4_f1_bound"] = gang_bound(n_cores * s_pool * rows_f1)
    t["k3_f1"] = cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_gang_bits(
        *w, x0c, core_map, offc, n_steps=steps_f1, s_block=s_block,
        t_block=cfg.t_block, unroll=cfg.unroll), reps=10, warmup=2)
    t["k3_f1_bound"] = t["k4_f1_bound"]
    t["k3_f2"] = cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_gang_bits(
        *w, x0c, core_map, offc, np.repeat(demand, s_pool // s_block),
        n_steps=steps_f2, s_block=s_block, t_block=cfg.t_block,
        unroll=cfg.unroll), reps=10, warmup=2)
    t["k3_f2_plain"] = cuda_ms(torch, lambda: ref.chaotic_ann_gang_bits_ref(
        *w, x0c, core_map, steps_f2, offc, eff), reps=1, warmup=1)
    t["k3_f2_bound"] = gang_bound(int(eff.sum()) * s_block)
    t["k4_f2"] = cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_gang_stacked(
        *w, x0s, offs, demand, n_steps=steps_f2), reps=10, warmup=2)
    t["k4_f2_bound"] = gang_bound(sum(demand) * s_pool)
    k1 = [[s.params[k] for k in ("w1", "b1", "w2", "b2")] for s in svcs]

    def solo_f1():
        for c in range(n_cores):
            chaotic_ann.chaotic_ann_bits(*k1[c], x0s[c], offs[c],
                                         n_steps=steps_f1)

    t["k1_x4_f1"] = cuda_ms(torch, solo_f1, reps=10, warmup=2)
    # K1 alone over all F1 lanes (chen's weights): the yardstick K4's
    # ratio to its bound is compared with, at the same lanes and rows
    t["k1_f1"] = cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_bits(
        *k1[0], x0c, offc, n_steps=steps_f1), reps=10, warmup=2)
    print(f"farm device times {tag} (3-8-3 gang of {n_cores} x {s_pool} "
          f"lanes, s_block {s_block}): F1 ({rows_f1} rows each) "
          f"chaotic_ann_gang_stacked {t['k4_f1']:.4f} ms (bound "
          f"{t['k4_f1_bound'][0]:.4f} ms by {t['k4_f1_bound'][1]}; plain "
          f"{t['k4_f1_plain']:.1f} ms), chaotic_ann_gang_bits "
          f"{t['k3_f1']:.4f} ms, gang=False 4 x chaotic_ann_bits "
          f"{t['k1_x4_f1']:.4f} ms, one chaotic_ann_bits over all "
          f"{n_cores * s_pool} lanes {t['k1_f1']:.4f} ms; F2 (rows {demand}, effective "
          f"{sorted(set(eff.tolist()))}) chaotic_ann_gang_bits "
          f"{t['k3_f2']:.4f} ms (bound {t['k3_f2_bound'][0]:.4f} ms by "
          f"{t['k3_f2_bound'][1]}; plain {t['k3_f2_plain']:.1f} ms), "
          f"chaotic_ann_gang_stacked freeze {t['k4_f2']:.4f} ms (bound "
          f"{t['k4_f2_bound'][0]:.4f} ms); card {card}")
    path = {k: sum(launches[f][k] for f in launches) for k in KERNELS}
    return path, t


def phase_lattice_farm(torch, device, dtype, tag, card, errs):
    """The lattice farm path: ``OscillatorFarm`` with the four LATTICE_FARM
    cores on ``default_config(96, 256, dtype, n_nodes=32)`` beside the
    scalar chen on its own vpu config, 128 clients x 128 lanes a core;
    three flushes (F1 uniform: stacked lattice K4; F2 skewed: the planner
    decides; F3 one more lorenz@ring32 client: lane-concat lattice K3),
    each held against a gang=False farm, F2 against a snapshot taken with
    its requests pending and restored onto a fresh farm; then the F1 K4
    launch and the F3 K3 launch against one plain run each at their
    shapes, bitwise, with their times and bounds.  Returns ({kernel:
    launches over the three flushes}, timings)."""
    from repro_torch.core.ann import lattice_meta_tuple
    from repro_torch.kernels import chaotic_ann, ref
    from repro_torch.prng.stream import _round_rows

    def make(gang=True):
        return make_lattice_farm(device, dtype, gang)

    farm, solo = make(), make(gang=False)
    cores = farm.cores
    clients = [f"c{i:03d}" for i in range(FARM_CLIENTS)]
    t_register = register_all(torch, (farm, solo), clients, 5000)
    lat_svcs = [farm.services[c] for c in LATTICE_FARM]
    check(all(s.config.compute_unit == "vpu" and s.config.n_nodes == 32
              for s in lat_svcs), f"lattice farm {tag}: configs "
                                  f"{[s.config for s in lat_svcs]}")
    w = [torch.stack([s.params[k] for s in lat_svcs])
         for k in ("w1", "b1", "w2", "b2")]
    lattice = lattice_meta_tuple(lat_svcs[0].params["lattice_meta"])

    hot = {c: LATTICE_WORDS if c == LATTICE else COLD_WORDS for c in cores}
    flushes = (("F1", {c: LATTICE_WORDS for c in cores}), ("F2", hot),
               ("F3", {c: LATTICE_WORDS for c in cores}))
    launches, outs, snap, shapes, walls = {}, {}, None, {}, {}
    for label, words in flushes:
        if label == "F3":                  # unequal pools: one more client
            for f in (farm, solo):
                f.register("lorenz@ring32", f"c{FARM_CLIENTS}", seed=99)
        request_all((farm, solo), words)
        if label == "F2":                  # requests pending
            snap = farm.snapshot()
        else:
            shapes[label] = launch_inputs(torch, device, lat_svcs)
        out, got, decisions, _, n_launched, walls[label] = counted_flush(
            torch, farm, solo, f"lattice farm {tag} {label}", card)
        launches[label] = got
        outs[label] = out
        check(got["chaotic_ann_gang_bits"] == 0
              and got["chaotic_ann_gang_stacked"] == 0,
              f"lattice farm {tag} {label}: a scalar gang kernel launched "
              f"({got}); the scalar chen has no gang partner")
        check(got["chaotic_ann_mxu_gang_bits"] + got["chaotic_ann_mxu_bits"]
              == 0, f"lattice farm {tag} {label}: an mxu kernel launched "
                    f"on the vpu farm ({got})")
        if label == "F1":
            check(decisions == {"padded": 1}
                  and got["chaotic_ann_lattice_gang_stacked"] == 1
                  and got["chaotic_ann_lattice_gang_bits"] == 0
                  and got["chaotic_ann_bits"] == 1
                  and n_launched == 2,
                  f"lattice farm {tag} F1: expected one padded lattice K4 "
                  f"launch and one K1 launch, got {decisions} {got}")
        elif label == "F2":
            check("padded" not in decisions
                  and got["chaotic_ann_lattice_gang_bits"]
                  + got["chaotic_ann_lattice_gang_stacked"]
                  + got["chaotic_ann_lattice_bits"] > 0,
                  f"lattice farm {tag} F2: expected ragged or split, got "
                  f"{decisions} {got}")
        else:
            check(decisions == {"padded": 1}
                  and got["chaotic_ann_lattice_gang_bits"] == 1
                  and got["chaotic_ann_lattice_gang_stacked"] == 0,
                  f"lattice farm {tag} F3: expected one padded lattice K3 "
                  f"launch, got {decisions} {got}")
    fresh = make()
    fresh.restore(snap)
    check(same_words(outs["F2"], fresh.flush()),
          f"lattice farm {tag}: F2 restored from a snapshot differs")
    path = {k: sum(launches[f][k] for f in launches) for k in KERNELS}
    for name in ("chaotic_ann_lattice_gang_bits",
                 "chaotic_ann_lattice_gang_stacked"):
        check(path[name] > 0, f"{name} not launched on the {tag} lattice "
                              f"farm path")
    print(f"lattice farm {tag}: {len(cores)} cores ({', '.join(cores)}) x "
          f"{FARM_CLIENTS} clients x {LANES_PER_CLIENT} lanes; register "
          f"{t_register:.3f} s per farm; every flush bitwise equal to the "
          f"gang=False farm, F2 to its snapshot restored")

    # F1's K4 and F3's K3 launches against one plain run each at their
    # shapes, bitwise, and their device times (not counted as path
    # launches); the farm's rows: demand rounded by _round_rows
    t_block = lat_svcs[0].config.t_block
    s_block = lat_svcs[0].config.s_block
    steps = 2 * _round_rows(LATTICE_WORDS // LANES_PER_CLIENT, t_block)
    pools, offsets = shapes["F1"]
    xs, offs = torch.stack(pools), torch.stack(offsets)
    pools, offsets = shapes["F3"]
    x0c, offc = torch.cat(pools), torch.cat(offsets)
    sizes = [p.shape[0] for p in pools]
    check(all(n % s_block == 0 for n in sizes),
          f"lattice farm {tag}: F3 pools {sizes} need no padding here")
    core_map = np.repeat(np.arange(len(sizes)), [n // s_block for n in sizes])
    t = {}
    for key, kernel, plain in (
            ("k4", lambda: chaotic_ann.chaotic_ann_gang_stacked(
                *w, xs, offs, n_steps=steps, lattice=lattice),
             lambda: ref.chaotic_ann_gang_stacked_ref(
                 *w, xs, steps, offs, lattice=lattice)),
            ("k3", lambda: chaotic_ann.chaotic_ann_gang_bits(
                *w, x0c, core_map, offc, n_steps=steps, s_block=s_block,
                t_block=t_block, unroll=lat_svcs[0].config.unroll,
                lattice=lattice),
             lambda: ref.chaotic_ann_gang_bits_ref(
                 *w, x0c, core_map, steps, offc, lattice=lattice))):
        (words_p, state_p), t[f"{key}_plain"] = timed_once(torch, plain)
        words_k, state_k = kernel()
        e = max(max_abs_err(torch, words_k, words_p),
                max_abs_err(torch, state_k, state_p))
        del words_p, state_p, words_k, state_k
        name = ("chaotic_ann_lattice_gang_stacked" if key == "k4"
                else "chaotic_ann_lattice_gang_bits")
        check(e == 0.0, f"{name} != plain at the lattice farm's "
                        f"{'F1' if key == 'k4' else 'F3'} shape ({tag})")
        errs[(name, tag)] = max(errs.get((name, tag), 0.0), e)
        t[key] = cuda_ms(torch, kernel, reps=5, warmup=1)
    item = xs.element_size()
    i_dim, h_dim = w[0].shape[1:]
    weight_bytes = 4 * (2 * i_dim * h_dim + h_dim + i_dim) * item
    ops_step = lattice_step_flops(lattice, h_dim)

    def gang_bound(n_lanes):
        # x0 read, state written, offsets and weights read, words written
        n_words = n_lanes * steps // 2
        return bound(n_words * 2 * ops_step,
                     2 * n_lanes * i_dim * item + n_lanes * 4 + weight_bytes
                     + n_words * 4, tag)

    t["k4_bound"] = gang_bound(xs.shape[0] * xs.shape[1])
    t["k3_bound"] = gang_bound(x0c.shape[0])
    # yardsticks in this call: one lattice K1 over F1's lanes (chen's
    # weights), and the gang=False cost of F1 (four lattice K1 launches)
    x1 = xs.reshape(-1, i_dim)
    t["k1_f1"] = cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_bits(
        *[a[0] for a in w], x1, offs.reshape(-1), n_steps=steps,
        lattice=lattice), reps=5, warmup=1)

    def solo_f1():
        for c in range(xs.shape[0]):
            chaotic_ann.chaotic_ann_bits(*[a[c] for a in w], xs[c], offs[c],
                                         n_steps=steps, lattice=lattice)

    t["k1_x4_f1"] = cuda_ms(torch, solo_f1, reps=5, warmup=1)
    t["walls"] = walls
    print(f"lattice farm device times {tag} ({LATTICE} descriptor, "
          f"{ops_step} ops a step, {steps} steps): F1 "
          f"chaotic_ann_lattice_gang_stacked (4 x {xs.shape[1]} lanes) "
          f"{t['k4']:.4f} ms (bound {t['k4_bound'][0]:.4f} ms by "
          f"{t['k4_bound'][1]}; plain {t['k4_plain']:.1f} ms; busy "
          f"{t['k4'] / (walls['F1'] * 1e3):.2%} of F1's wall), "
          f"gang=False 4 x chaotic_ann_lattice_bits {t['k1_x4_f1']:.4f} ms, "
          f"one chaotic_ann_lattice_bits over all {x1.shape[0]} lanes "
          f"{t['k1_f1']:.4f} ms; F3 chaotic_ann_lattice_gang_bits "
          f"({x0c.shape[0]} lanes, s_block {s_block}) {t['k3']:.4f} ms "
          f"(bound {t['k3_bound'][0]:.4f} ms by {t['k3_bound'][1]}; plain "
          f"{t['k3_plain']:.1f} ms; busy "
          f"{t['k3'] / (walls['F3'] * 1e3):.2%} of F3's wall); card {card}")
    return path, t


def phase_mxu_farm(torch, device, dtype, tag, card, errs):
    """The mxu farm path: ``OscillatorFarm`` with the four LATTICE_FARM
    cores added with NO config (``select_config`` puts them on the mxu
    unit: the JAX farm's default lattice gang) beside the four 3-8-3
    registry nets on ``select_config(3, 8, s_total=128, unit="mxu")``, 128
    clients x 128 lanes a core, MXU_WORDS a client.  Three flushes (F1
    uniform: one padded mxu K3 launch a group; F2 skewed: the planner
    decides; F3 one more lorenz@ring32 client: a padded lane-concat mxu
    K3), each held against a gang=False farm (every core its own mxu K1),
    F2 against a snapshot taken with its requests pending and restored
    onto a fresh farm; then F3's lattice mxu K3 launch against one plain
    run on each core's first and last lane block (lanes are independent),
    bitwise, and the mxu K3's times at F1 and F3 beside four solo mxu K1
    launches over F1's lanes.  Returns ({kernel: launches over the three
    flushes}, timings)."""
    from repro_torch.core.ann import lattice_meta_tuple
    from repro_torch.kernels import chaotic_ann, ref
    from repro_torch.prng.stream import _round_rows

    scalar = GANGS["3-8"]

    def make(gang=True):
        return make_mxu_farm(device, dtype, gang)

    farm, solo = make(), make(gang=False)
    cores = farm.cores
    for core in cores:
        c = farm.services[core].config
        print(f"mxu farm {tag}: {core} config "
              f"{'resolved' if core in LATTICE_FARM else 'given'} {c} "
              f"(s_block {c.s_block})")
        check(c.compute_unit == "mxu" and c.s_block == 128
              and c.t_block == 256 and c.unroll == 8,
              f"mxu farm {tag}: {core} config {c}")
    for group, n_nodes in ((LATTICE_FARM, 32), (scalar, 1)):
        s_block = farm.services[group[0]].config.s_block
        print(f"mxu farm {tag}: mxu K3 group {', '.join(group)}: n_nodes "
              f"{n_nodes}, s_block {s_block}, "
              f"{mirrored_share(n_nodes, s_block):.1%} of the two-lane "
              f"kernel's lane halves mirrored")
    clients = [f"c{i:03d}" for i in range(FARM_CLIENTS)]
    t_register = register_all(torch, (farm, solo), clients, 7000)
    lat_svcs = [farm.services[c] for c in LATTICE_FARM]
    scalar_svcs = [farm.services[c] for c in scalar]
    w = [torch.stack([s.params[k] for s in lat_svcs])
         for k in ("w1", "b1", "w2", "b2")]
    lattice = lattice_meta_tuple(lat_svcs[0].params["lattice_meta"])
    cpl = lat_svcs[0].params["coupling"]

    hot = {c: MXU_WORDS if c in (LATTICE, "chen") else MXU_COLD_WORDS
           for c in cores}
    flushes = (("F1", {c: MXU_WORDS for c in cores}), ("F2", hot),
               ("F3", {c: MXU_WORDS for c in cores}))
    launches, outs, snap, shapes, walls = {}, {}, None, {}, {}
    for label, words in flushes:
        if label == "F3":                  # unequal pools: one more client
            for f in (farm, solo):
                f.register("lorenz@ring32", f"c{FARM_CLIENTS}", seed=99)
        request_all((farm, solo), words)
        if label == "F2":                  # requests pending
            snap = farm.snapshot()
        else:
            shapes[label] = launch_inputs(torch, device, lat_svcs)
        if label == "F1":
            shapes["F1 scalar"] = launch_inputs(torch, device, scalar_svcs)
        out, got, decisions, modes, n_launched, walls[label] = counted_flush(
            torch, farm, solo, f"mxu farm {tag} {label}", card)
        launches[label] = got
        outs[label] = out
        stacked = (got["chaotic_ann_gang_stacked"]
                   + got["chaotic_ann_lattice_gang_stacked"])
        vpu = sum(got[k] for k in ("chaotic_ann_bits", "chaotic_ann_traj",
                                   "chaotic_ann_gang_bits",
                                   "chaotic_ann_lattice_bits",
                                   "chaotic_ann_lattice_traj",
                                   "chaotic_ann_lattice_gang_bits"))
        check(stacked == 0 and vpu == 0 and modes == ["concat"],
              f"mxu farm {tag} {label}: K4 or a vpu kernel launched, or a "
              f"stacked plan ({got}, {modes})")
        if label == "F2":
            check("padded" not in decisions
                  and got["chaotic_ann_mxu_gang_bits"]
                  + got["chaotic_ann_mxu_bits"] > 0,
                  f"mxu farm {tag} F2: expected ragged or split, got "
                  f"{decisions} {got}")
        else:
            check(decisions == {"padded": 2}
                  and got["chaotic_ann_mxu_gang_bits"] == 2
                  and got["chaotic_ann_mxu_bits"] == 0 and n_launched == 2,
                  f"mxu farm {tag} {label}: expected one padded mxu K3 "
                  f"launch a group and no mxu K1, got {decisions} {got}")
    fresh = make()
    fresh.restore(snap)
    check(same_words(outs["F2"], fresh.flush()),
          f"mxu farm {tag}: F2 restored from a snapshot differs")
    path = {k: sum(launches[f][k] for f in launches) for k in KERNELS}
    print(f"mxu farm {tag}: {len(cores)} cores ({', '.join(cores)}) x "
          f"{FARM_CLIENTS} clients x {LANES_PER_CLIENT} lanes; register "
          f"{t_register:.3f} s per farm; every flush bitwise equal to the "
          f"gang=False farm (each core its own mxu K1), F2 to its snapshot "
          f"restored")

    # F3's lattice launch against one plain run on each core's first and
    # last block, bitwise; the mxu K3's times at F1 and F3 (not counted as
    # path launches); the farm's rows: demand rounded by _round_rows
    cfg = lat_svcs[0].config
    steps = 2 * _round_rows(MXU_WORDS // LANES_PER_CLIENT, cfg.t_block)
    pools, offsets = shapes["F1"]
    x1, off1 = torch.cat(pools), torch.cat(offsets)
    map1 = np.repeat(np.arange(len(pools)),
                     [p.shape[0] // cfg.s_block for p in pools])
    pools, offsets = shapes["F3"]
    x0c, offc = torch.cat(pools), torch.cat(offsets)
    sizes = [p.shape[0] for p in pools]
    check(all(n % cfg.s_block == 0 for n in sizes),
          f"mxu farm {tag}: F3 pools {sizes} need no padding here")
    core_map = np.repeat(np.arange(len(sizes)),
                         [n // cfg.s_block for n in sizes])
    kw = dict(n_steps=steps, s_block=cfg.s_block, t_block=cfg.t_block,
              unroll=cfg.unroll, compute_unit="mxu", lattice=lattice,
              coupling=cpl)
    first = np.searchsorted(core_map, np.arange(len(sizes)))
    blocks = np.unique(np.concatenate([first, first + np.asarray(sizes)
                                       // cfg.s_block - 1]))
    lanes = torch.as_tensor(
        (blocks[:, None] * cfg.s_block + np.arange(cfg.s_block)).reshape(-1),
        device=device)
    t = {}
    words_k, state_k = chaotic_ann.chaotic_ann_gang_bits(
        *w, x0c, core_map, offc, **kw)
    (words_p, state_p), t["k3_plain"] = timed_once(
        torch, lambda: ref.chaotic_ann_gang_bits_ref(
            *w, x0c[lanes], core_map[blocks], steps, offc[lanes],
            lattice=lattice, compute_unit="mxu", coupling=cpl))
    # uint32 has few CUDA ops: gather the words' columns as int32
    picked = words_k.view(torch.int32)[:, lanes].view(torch.uint32)
    e = max(max_abs_err(torch, picked, words_p),
            max_abs_err(torch, state_k[lanes], state_p))
    del words_k, state_k, words_p, state_p, picked
    print(f"check mxu farm {tag} F3 shape ({x0c.shape[0]} lanes, "
          f"{len(core_map)} blocks): chaotic_ann_mxu_gang_bits vs one plain "
          f"run on blocks {blocks.tolist()} (each core's first and last, "
          f"{lanes.numel()} lanes) max_abs_err={e}")
    check(e == 0.0, f"chaotic_ann_mxu_gang_bits != plain at the mxu farm's "
                    f"F3 shape ({tag})")
    errs[("chaotic_ann_mxu_gang_bits", tag)] = max(
        errs.get(("chaotic_ann_mxu_gang_bits", tag), 0.0), e)
    t["plain_lanes"] = lanes.numel()
    t["k3"] = cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_gang_bits(
        *w, x0c, core_map, offc, **kw), reps=5, warmup=1)
    t["k3_f1"] = cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_gang_bits(
        *w, x1, map1, off1, **kw), reps=5, warmup=1)
    k1 = dict(n_steps=steps, compute_unit="mxu", lattice=lattice,
              coupling=cpl)

    def solo_f1():
        for c, (p, o) in enumerate(zip(*shapes["F1"])):
            chaotic_ann.chaotic_ann_bits(*[a[c] for a in w], p, o, **k1)

    t["k1_x4_f1"] = cuda_ms(torch, solo_f1, reps=5, warmup=1)
    # the scalar group's F1 launch (s_block 128: every CTA holds one live
    # lane half) beside its four solo mxu K1 launches (no mirrors)
    ws = [torch.stack([s.params[k] for s in scalar_svcs])
          for k in ("w1", "b1", "w2", "b2")]
    pools, offsets = shapes["F1 scalar"]
    s_cfg = scalar_svcs[0].config
    xs, offs = torch.cat(pools), torch.cat(offsets)
    maps = np.repeat(np.arange(len(pools)),
                     [q.shape[0] // s_cfg.s_block for q in pools])
    skw = dict(n_steps=steps, s_block=s_cfg.s_block, t_block=s_cfg.t_block,
               unroll=s_cfg.unroll, compute_unit="mxu")
    t["k3_scalar_f1"] = cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_gang_bits(
        *ws, xs, maps, offs, **skw), reps=5, warmup=1)

    def solo_scalar_f1():
        for c, (q, o) in enumerate(zip(pools, offsets)):
            chaotic_ann.chaotic_ann_bits(*[a[c] for a in ws], q, o,
                                         n_steps=steps, compute_unit="mxu")

    t["k1_x4_scalar_f1"] = cuda_ms(torch, solo_scalar_f1, reps=5, warmup=1)
    item = x0c.element_size()
    i_dim, h_dim = w[0].shape[1:]
    weight_bytes = 4 * (2 * i_dim * h_dim + h_dim + i_dim) * item
    mxu_step = mxu_step_flops(i_dim, h_dim, lattice)
    ops_step = sum(mxu_step)

    def gang_bound(n_lanes):
        # x0 read, state written, offsets, weights, coupling and maps read,
        # words written; the f32 FMA chains at the mxu rate (2 flops each),
        # the adds at the state dtype's rate
        n_words = n_lanes * steps // 2
        return mxu_bound(n_words * 2, mxu_step,
                         2 * n_lanes * i_dim * item + n_lanes * 4
                         + weight_bytes + i_dim * i_dim * item
                         + 8 * n_lanes // cfg.s_block + n_words * 4, tag)

    t["k3_bound"] = gang_bound(x0c.shape[0])
    t["k3_f1_bound"] = gang_bound(x1.shape[0])
    t["walls"] = walls
    print(f"mxu farm device times {tag} ({LATTICE} descriptor, {ops_step} "
          f"ops a step, {steps} steps): F1 chaotic_ann_mxu_gang_bits "
          f"({x1.shape[0]} lanes) {t['k3_f1']:.4f} ms (bound "
          f"{t['k3_f1_bound'][0]:.4f} ms by {t['k3_f1_bound'][1]}; busy "
          f"{t['k3_f1'] / (walls['F1'] * 1e3):.2%} of F1's wall), "
          f"gang=False 4 x chaotic_ann_mxu_bits {t['k1_x4_f1']:.4f} ms; F3 "
          f"chaotic_ann_mxu_gang_bits ({x0c.shape[0]} lanes, s_block "
          f"{cfg.s_block}) {t['k3']:.4f} ms (bound {t['k3_bound'][0]:.4f} ms"
          f" by {t['k3_bound'][1]}; plain on {lanes.numel()} lanes "
          f"{t['k3_plain']:.1f} ms; busy {t['k3'] / (walls['F3'] * 1e3):.2%}"
          f" of F3's wall); the 3-8-3 group at F1 ({xs.shape[0]} lanes, "
          f"s_block {s_cfg.s_block}, "
          f"{mirrored_share(1, s_cfg.s_block):.1%} of lane halves mirrored) "
          f"chaotic_ann_mxu_gang_bits {t['k3_scalar_f1']:.4f} ms, gang=False "
          f"4 x chaotic_ann_mxu_bits {t['k1_x4_scalar_f1']:.4f} ms; card "
          f"{card}")
    return path, t


def run_testbenches(pkgs) -> None:
    """Each generated core's ``testbench.py`` in its own process on the
    card, all started together; every process is waited for (killed on a
    failure), and any non-zero exit fails the phase."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [(pkg, subprocess.Popen(
        [sys.executable, str(pkg / "testbench.py"), "cuda"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for pkg in pkgs]
    try:
        for pkg, proc in procs:
            out, err = proc.communicate(timeout=300)
            print(f"testbench {pkg.name} (exit {proc.returncode}): "
                  f"{out.strip() or err.strip()[-800:]}")
            check(proc.returncode == 0 and "TESTBENCH PASS" in out,
                  f"testbench of {pkg.name} failed on the card")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_activation_hook(torch, device) -> None:
    """The kernels' tanh and sigmoid alone (``chaotic_ann.activation``)
    against the plain formulas: every finite bf16 pattern, and 2**24
    seeded f32 inputs over the formulas' range with their edges."""
    from repro_torch.kernels import chaotic_ann, ref
    pat = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    xb = pat.view(torch.bfloat16).to(device)
    xb = xb[torch.isfinite(xb.float())]
    rng = np.random.default_rng(10)
    edges = np.array([0.0004, 7.99881172180175781, 88.3762626647949, 87.34,
                      87.5, 88.0, 103.0, 1e-40, 1.4e-45, 0.0], np.float32)
    edges = np.concatenate([edges, -edges])
    edges = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                            np.nextafter(edges, np.float32(-np.inf))])
    n = ACT_F32_INPUTS
    x = torch.from_numpy(np.concatenate([
        rng.normal(0.0, 3.0, n // 2), rng.uniform(-110.0, 110.0, n // 4),
        rng.uniform(-1e-3, 1e-3, n - n // 2 - n // 4), edges]
    ).astype(np.float32)).to(device)
    for name in PAPER_ACTIVATIONS:
        for xs, tag in ((xb, "bf16"), (x, "f32")):
            got = chaotic_ann.activation(xs, name)
            want = ref.ACTIVATIONS[name](xs)
            e = max_abs_err(torch, got, want)
            print(f"check device {name} {tag} on {xs.numel()} inputs: "
                  f"max_abs_err={e}")
            check(e == 0.0, f"device {name} != plain ({tag})")


def phase_paper_flow(torch, device, card, errs):
    """Phase 10, the paper's flow for tanh and sigmoid nets: the chen
    dataset, training on the card, the DSE's two solutions, a generated
    core and its testbench for each, 2**20 words from
    ``ChaoticStream.from_trained``, and the NIST subset; then the scalar
    vpu K1/K2 with that activation against their plain versions and timed.
    Returns ({(kernel, activation, tag): path launches}, {...: times},
    {activation: (the trained net's numpy bundle, scale, offset)}, the
    chen dataset)."""
    import importlib
    import tempfile
    from repro_torch.core.ann import (AnnConfig, extract_parameters,
                                      params_from_numpy, train)
    from repro_torch.core.chaotic import make_dataset
    from repro_torch.core.codegen import generate_core
    from repro_torch.core.dse import Candidate, select
    from repro_torch.kernels import chaotic_ann, ops, ref
    from repro_torch.prng.nist import run_nist_subset
    from repro_torch.prng.stream import ChaoticStream

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = make_dataset("chen", n_samples=PAPER_SAMPLES, device=device)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds_cpu = make_dataset("chen", n_samples=PAPER_SAMPLES, device="cpu")
    t_cpu = time.perf_counter() - t0
    same = bool(np.array_equal(ds.x_train, ds_cpu.x_train))
    print(f"paper flow: chen dataset, {PAPER_SAMPLES} samples, RK-4 on the "
          f"card {t_card:.2f} s, on the host's CPU {t_cpu:.2f} s (the same "
          f"pairs: {same}); scale {ds.scale}, offset {ds.offset} (CPU: "
          f"{ds_cpu.scale}, {ds_cpu.offset}); card {card}")
    check(np.allclose(ds.scale, ds_cpu.scale, rtol=0.1)
          and np.abs(ds.offset - ds_cpu.offset).max()
          <= 0.1 * ds_cpu.scale.min(),
          "the card's and the CPU's datasets span different attractor boxes")
    del ds_cpu
    cands = {}
    for mode, want in PAPER_SELECT.items():
        cands[mode] = select(3, 8, mode)
        print(f"paper flow: select(3, 8, {mode!r}) = {cands[mode]}")
        check(cands[mode] == Candidate(**want),
              f"select {mode}: {cands[mode]} is not the JAX package's")
    launches, times, mse, nets = {}, {}, {}, {}
    tmp = tempfile.TemporaryDirectory(prefix="paper_flow_")
    sys.path.insert(0, tmp.name)
    try:
        for act in PAPER_ACTIVATIONS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, hist = train(AnnConfig(dim=3, hidden=8, activation=act),
                                 ds, epochs=PAPER_EPOCHS, batch_size=256,
                                 lr=3e-3, device=device)
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            m = hist["test_metrics"]
            mse[act] = m["mse"]
            print(f"paper flow {act}: trained {PAPER_EPOCHS} epochs on the "
                  f"card in {t_train:.1f} s ({t_train / PAPER_EPOCHS:.3f} s "
                  f"an epoch); MSE={m['mse']:.4g} MAE={m['mae']:.4g} "
                  f"RMSE={m['rmse']:.4g} R2={m['r2']:.6f}; card {card}")
            check(np.isfinite(list(m.values())).all() and m["r2"] > 0.99,
                  f"{act} training: {m}")
            bundle = extract_parameters(params)
            nets[act] = (bundle, ds.scale, ds.offset)
            pkgs = [generate_core(f"chen_383_{act}_{mode}", tmp.name,
                                  params=bundle, candidate=cand,
                                  system="chen", activation=act,
                                  scale=ds.scale, offset=ds.offset)
                    for mode, cand in cands.items()]
            t0 = time.perf_counter()
            run_testbenches(pkgs)
            print(f"paper flow {act}: testbenches "
                  f"{time.perf_counter() - t0:.1f} s")

            # the path, each part with the counters zeroed just before it
            # and read just after: the stream (K1 f32), the trained net
            # iterated on the card (K2 f32), the min-latency core (bf16)
            def counted(fn, name, tag):
                out, got = counted_path(torch, fn, name, f"{act} {tag}")
                launches[(name, act, tag)] = got[name]
                return out

            stream = ChaoticStream.from_trained(bundle, activation=act,
                                                device=device)
            words = counted(lambda: stream.bits(NIST_WORDS).numpy(),
                            "chaotic_ann_bits", "f32")
            path_out = {"stream words": (
                words[:PAPER_STREAM_CHECK_WORDS], ChaoticStream.from_trained(
                    bundle, activation=act, device=device,
                    backend="ref").bits(PAPER_STREAM_CHECK_WORDS).numpy())}
            res = run_nist_subset(words, alpha=NIST_ALPHA)
            print(f"nist {act} trained chen on {words.size} words of "
                  f"ChaoticStream.from_trained (not gated): "
                  + ", ".join(f"{k} p={v['p_value']:.4g}"
                              for k, v in res.items()))
            p_dev = params_from_numpy(bundle, device=device)
            x_att = torch.as_tensor(ds.x_test[:ATTRACTOR_LANES],
                                    device=device)
            traj = counted(lambda: ops.chaotic_trajectory(
                p_dev, x_att, ATTRACTOR_STEPS, activation=act),
                "chaotic_ann_traj", "f32")
            amax = float(traj.abs().max())
            std = float(traj[-500:].std())
            print(f"paper flow {act}: {ATTRACTOR_STEPS} autonomous steps "
                  f"of {ATTRACTOR_LANES} lanes on the card: max|x| "
                  f"{amax:.4g}, std of the last 500 {std:.4g}")
            check(bool(torch.isfinite(traj).all()) and amax < 5.0,
                  f"{act}: the trained net leaves the attractor box")
            path_out["attractor"] = (traj, ops.chaotic_trajectory(
                p_dev, x_att, ATTRACTOR_STEPS, activation=act,
                backend="ref"))
            core = importlib.import_module(f"chen_383_{act}_min_latency")
            x0 = np.random.default_rng(3).uniform(
                -0.5, 0.5, (core.S_BLOCK, 3)).astype(np.float32)
            path_out["core generate"] = (
                counted(lambda: core.generate(x0, PAPER_CORE_STEPS,
                                              device=device),
                        "chaotic_ann_traj", "bf16"),
                core.generate(x0, PAPER_CORE_STEPS, backend="ref",
                              device=device))
            path_out["core generate_bits"] = (
                counted(lambda: core.generate_bits(
                    x0, 2 * PAPER_CORE_STEPS, device=device),
                    "chaotic_ann_bits", "bf16"),
                core.generate_bits(x0, 2 * PAPER_CORE_STEPS, backend="ref",
                                   device=device))
            for what, (got, want) in path_out.items():
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                e = max(max_abs_err(torch, torch.as_tensor(g),
                                    torch.as_tensor(w))
                        for g, w in zip(got, want))
                shape = tuple(np.shape(got[0]))
                print(f"check {act} path: {what} {shape} against the plain "
                      f"path: max_abs_err={e}")
                check(e == 0.0, f"{act} path: {what} != plain")
            del path_out

            # the kernels against their plain versions, and timed
            w = [p_dev[k] for k in ("w1", "b1", "w2", "b2")]
            for dtype, tag in ((torch.float32, "f32"),
                               (torch.bfloat16, "bf16")):
                for mode in cands:
                    s_block = cands[mode].s_block
                    xc = torch.as_tensor(np.random.default_rng(4).uniform(
                        -0.5, 0.5, (s_block, 3)).astype(np.float32),
                        device=device).to(dtype)
                    t_k = chaotic_ann.chaotic_ann_traj(
                        *w, xc, n_steps=PAPER_CORE_STEPS, activation=act)
                    w_k, s_k = chaotic_ann.chaotic_ann_bits(
                        *w, xc, 5, n_steps=PAPER_CORE_STEPS, activation=act)
                    t_p = ref.chaotic_ann_ref(*w, xc, PAPER_CORE_STEPS, act)
                    e = max(max_abs_err(torch, t_k, t_p),
                            max_abs_err(torch, w_k, ops.pack_words(t_p, 5)),
                            max_abs_err(torch, s_k, t_p[-1]))
                    print(f"check {act} {tag} S={s_block} steps="
                          f"{PAPER_CORE_STEPS} ({mode} core's s_block): "
                          f"K1, K2 max_abs_err={e}")
                    check(e == 0.0, f"{act} K1/K2 != plain ({tag}, "
                                    f"S={s_block})")
                times[(act, tag)] = paper_kernel_times(
                    torch, device, w, act, dtype, tag, card, errs)
            sys.modules.pop(f"chen_383_{act}_min_latency", None)
    finally:
        sys.path.remove(tmp.name)
        tmp.cleanup()
    print(f"paper flow: test MSE tanh {mse['tanh']:.4g}, sigmoid "
          f"{mse['sigmoid']:.4g} (the JAX test's ordering: tanh < sigmoid)")
    check(mse["tanh"] < mse["sigmoid"],
          f"Table II ordering tanh < sigmoid fails: {mse}")
    return launches, times, nets, ds


def paper_kernel_times(torch, device, w, act, dtype, tag, card, errs):
    """tanh/sigmoid K1 and K2 at the served shape (65,536 lanes, 1,024
    steps) against one plain run, bitwise, then their device times, relu's
    K1 beside them on the same weights and inputs, the plain times and
    the bounds."""
    from repro_torch.kernels import chaotic_ann, ops, ref
    n, steps = PAPER_CHECK_LANES, PAPER_CHECK_STEPS
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32),
                        device=device).to(dtype)
    off_np = rng.integers(0, 1 << 32, n, dtype=np.int64)
    off_np[:64] = (1 << 32) - 1 - 3 * np.arange(64)     # wrap mid-run
    off = torch.as_tensor(off_np, device=device)
    kw = dict(n_steps=steps, activation=act)
    traj_p, plain_traj_ms = timed_once(
        torch, lambda: ref.chaotic_ann_ref(*w, x, steps, act))
    words_p, pack_ms = timed_once(torch, lambda: ops.pack_words(traj_p, off))
    words_k, state_k = chaotic_ann.chaotic_ann_bits(*w, x, off, **kw)
    e_bits = max(max_abs_err(torch, words_k, words_p),
                 max_abs_err(torch, state_k, traj_p[-1]))
    traj_k = chaotic_ann.chaotic_ann_traj(*w, x, **kw)
    e_traj = max_abs_err(torch, traj_k, traj_p)
    del traj_k, words_k, words_p
    print(f"check {act} {tag} S={n} steps={steps} (the served shape): "
          f"chaotic_ann_bits max_abs_err={e_bits} chaotic_ann_traj "
          f"max_abs_err={e_traj} max|x|={traj_p.float().abs().max().item():.6g}")
    check(e_bits == 0.0, f"{act} chaotic_ann_bits != plain ({tag})")
    check(e_traj == 0.0, f"{act} chaotic_ann_traj != plain ({tag})")
    for name, e in (("chaotic_ann_bits", e_bits), ("chaotic_ann_traj", e_traj)):
        errs[(name, act, tag)] = e
    del traj_p
    t = {"bits_ms": cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_bits(
             *w, x, off, **kw), reps=5, warmup=2),
         "relu_bits_ms": cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_bits(
             *w, x, off, n_steps=steps), reps=5, warmup=2),
         "traj_ms": cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_traj(
             *w, x, **kw), reps=3, warmup=1),
         "traj_plain_ms": plain_traj_ms,
         "bits_plain_ms": plain_traj_ms + pack_ms}
    item, i_dim, h_dim = x.element_size(), 3, 8
    base, extra = step_flops(i_dim, h_dim), h_dim * ACT_OPS[act]
    weight_bytes = (2 * i_dim * h_dim + h_dim + i_dim) * item
    n_out = steps // 2 * n
    t["bits_bound"] = bound(n_out * 2 * base,
                            2 * n * i_dim * item + n * 4 + weight_bytes
                            + n_out * 4, tag, f32_flops=n_out * 2 * extra)
    t["traj_bound"] = bound(steps * n * base,
                            n * i_dim * item + weight_bytes
                            + steps * n * i_dim * item, tag,
                            f32_flops=steps * n * extra)
    t["ops_step"] = base + extra
    print(f"device times {act} {tag} (S={n}, n_steps={steps}, {base} + "
          f"{extra} ops a step): chaotic_ann_bits {t['bits_ms']:.4f} ms "
          f"(relu's {t['relu_bits_ms']:.4f} ms in this call; bound "
          f"{t['bits_bound'][0]:.4f} ms by {t['bits_bound'][1]}); plain "
          f"{t['bits_plain_ms']:.1f} ms; chaotic_ann_traj "
          f"{t['traj_ms']:.4f} ms (bound {t['traj_bound'][0]:.4f} ms by "
          f"{t['traj_bound'][1]}); plain {t['traj_plain_ms']:.1f} ms; "
          f"card {card}")
    return t


def train_gen_nets(torch, device, card, chen_nets):
    """The 3-8-3 tanh and sigmoid nets of phase 11: chen's from phase 10
    (``chen_nets``), the others trained on the card per activation, on
    one ``make_dataset(system, GEN_SAMPLES)`` a system.  Returns
    {(system, activation): (numpy bundle, scale, offset)}."""
    from repro_torch.core.ann import AnnConfig, extract_parameters, train
    from repro_torch.core.chaotic import make_dataset
    nets = {("chen", act): chen_nets[act] for act in PAPER_ACTIVATIONS}
    for system in GEN_SYSTEMS[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds = make_dataset(system, n_samples=GEN_SAMPLES, device=device)
        print(f"generated farm: {system} dataset, {GEN_SAMPLES} samples, "
              f"RK-4 on the card {time.perf_counter() - t0:.2f} s")
        for act in PAPER_ACTIVATIONS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, hist = train(AnnConfig(dim=3, hidden=8, activation=act),
                                 ds, epochs=PAPER_EPOCHS, batch_size=256,
                                 lr=3e-3, device=device)
            torch.cuda.synchronize()
            m = hist["test_metrics"]
            print(f"generated farm: {system} {act} trained {PAPER_EPOCHS} "
                  f"epochs on the card in {time.perf_counter() - t0:.1f} s; "
                  f"MSE={m['mse']:.4g} R2={m['r2']:.6f}; card {card}")
            check(np.isfinite(list(m.values())).all(),
                  f"{system} {act} training: {m}")
            nets[(system, act)] = (extract_parameters(params), ds.scale,
                                   ds.offset)
    return nets


def write_gen_dir(farm_dir, nets) -> None:
    """``generate_farm`` (relu, every registered system, "pareto") and a
    ``generate_core`` for each trained net as ``<system>_<activation>``
    on ``select(3, 8, "pareto")``; every ``Candidate`` printed and held to
    the JAX package's (GEN_SELECT)."""
    from repro_torch.core.codegen import generate_core, generate_farm
    from repro_torch.core.dse import Candidate, select
    for name, pkg in generate_farm(farm_dir).items():
        cand = Candidate(**json.loads(
            (pkg / "solution.json").read_text())["candidate"])
        print(f"generated farm: generate_farm {name}: {cand}")
        check(cand == Candidate(**GEN_SELECT[(cand.i_dim, cand.h_dim)]),
              f"generate_farm {name}: {cand} is not the JAX package's")
    cand = select(3, 8, "pareto")
    print(f"generated farm: select(3, 8, 'pareto') = {cand}")
    check(cand == Candidate(**GEN_SELECT[(3, 8)]),
          f"select(3, 8, 'pareto'): {cand} is not the JAX package's")
    for (system, act), (bundle, scale, offset) in sorted(nets.items()):
        generate_core(f"{system}_{act}", farm_dir, params=bundle,
                      candidate=cand, system=system, activation=act,
                      scale=scale, offset=offset)


def gen_farm(torch, device, farm_dir, tag, gang=True):
    """The generated farm: bf16 through ``from_generated``; f32 as the
    same cores and (clamped) solutions at dtype_bytes=4 through
    ``add_core``."""
    from repro_torch.serve.farm import OscillatorFarm
    farm = OscillatorFarm.from_generated(farm_dir, gang=gang, profile=True,
                                         device=device)
    if tag == "bf16":
        return farm
    f32 = OscillatorFarm(gang=gang, profile=True, device=device)
    for name, svc in farm.services.items():
        with np.load(pathlib.Path(farm_dir) / name / "weights.npz") as npz:
            weights = dict(npz)
        f32.add_core(name, weights, config=dataclasses.replace(
            svc.config, dtype_bytes=4), dtype=torch.float32,
            activation=svc.activation)
    return f32


class GangRecorder:
    """Wraps ``ops.chaotic_bits_gang`` / ``_stacked`` (what the farm calls)
    while active: each call on the card is recorded with its inputs, its
    outputs, its activation, and the launches its wrapper counted for it.
    ``replay`` then holds every recorded launch against the plain gang
    scan on each core's first and last lane block, bitwise, and times
    it."""

    NAMES = {"chaotic_bits_gang": "chaotic_ann_gang_bits",
             "chaotic_bits_gang_stacked": "chaotic_ann_gang_stacked"}
    # the wrappers that count a group of lattice cores' launches
    LATTICE_NAMES = {
        "chaotic_bits_gang": "chaotic_ann_lattice_gang_bits",
        "chaotic_bits_gang_stacked": "chaotic_ann_lattice_gang_stacked"}
    # an mxu group's, scalar or lattice (K4 has no mxu form)
    MXU_NAMES = {"chaotic_bits_gang": "chaotic_ann_mxu_gang_bits"}

    def __init__(self, torch):
        from repro_torch.kernels import chaotic_ann, ops
        self.torch, self.ops, self.chaotic_ann = torch, ops, chaotic_ann
        self.orig = {f: getattr(ops, f) for f in self.NAMES}
        self.calls = []

    def __enter__(self):
        for f in self.NAMES:
            setattr(self.ops, f, self._wrap(f))
        return self

    def __exit__(self, *exc):
        for f, fn in self.orig.items():
            setattr(self.ops, f, fn)

    def _wrap(self, f):
        def call(params, x0, n_steps, word_offset=0, **kw):
            unit = kw["config"].compute_unit
            names = (self.MXU_NAMES if unit == "mxu"
                     else self.LATTICE_NAMES if "lattice_meta" in params
                     else self.NAMES)
            counter = getattr(self.chaotic_ann, names[f])
            n0 = counter.launches
            x_in = x0.clone()
            out = self.orig[f](params, x0, n_steps, word_offset, **kw)
            self.calls.append(dict(
                kernel=names[f], f=f, params=params, x0=x_in,
                n_steps=n_steps, word_offset=word_offset, kw=kw, out=out,
                activation=kw.get("activation", "relu"),
                launches=counter.launches - n0))
            return out
        return call

    def rows(self, rec):
        """The word rows each lane (K3: (S,)) or core (K4: (C, 1))
        computes, as an int64 tensor on the card."""
        torch, chaotic_ann = self.torch, self.chaotic_ann
        n_rows, rm = rec["n_steps"] // 2, rec["kw"].get("row_map")
        if rec["f"] == "chaotic_bits_gang_stacked":
            n_cores = rec["x0"].shape[0]
            rows = (np.full(n_cores, n_rows) if rm is None
                    else np.minimum(rm, n_rows))
            return torch.as_tensor(rows.astype(np.int64),
                                   device=rec["x0"].device)[:, None]
        cfg = rec["kw"]["config"]
        n_blocks = len(rec["kw"]["core_map"])
        rows = (np.full(n_blocks, n_rows) if rm is None else
                chaotic_ann.gang_effective_rows(rm, rec["n_steps"],
                                                cfg.t_block, cfg.unroll))
        return torch.as_tensor(np.repeat(rows, cfg.s_block).astype(np.int64),
                               device=rec["x0"].device)

    def _subset(self, rec):
        """The lanes a replay holds: each core's first and last lane block
        (K3), or each pool's first and last CTA of lanes (K4); lanes are
        independent.  Returns (plain inputs, kernel words and state on
        those lanes, their rows)."""
        torch = self.torch
        x0, off = rec["x0"], rec["word_offset"]
        words_k, state_k = rec["out"]
        lane_rows = self.rows(rec)
        if rec["f"] == "chaotic_bits_gang_stacked":
            n = x0.shape[1]
            idx = np.unique(np.concatenate([np.arange(min(128, n)),
                                            np.arange(max(0, n - 128), n)]))
            lanes = torch.as_tensor(idx, device=x0.device)
            return (x0[:, lanes], off[:, lanes], None,
                    words_k.view(torch.int32)[:, :, lanes].view(torch.uint32),
                    state_k[:, lanes], lane_rows, idx.size)
        cfg = rec["kw"]["config"]
        core_map = np.asarray(rec["kw"]["core_map"])
        first = np.array([np.flatnonzero(core_map == c)[0]
                          for c in np.unique(core_map)])
        last = np.array([np.flatnonzero(core_map == c)[-1]
                         for c in np.unique(core_map)])
        blocks = np.unique(np.concatenate([first, last]))
        lanes = torch.as_tensor(
            (blocks[:, None] * cfg.s_block + np.arange(cfg.s_block))
            .reshape(-1), device=x0.device)
        return (x0[lanes], off[lanes], core_map[blocks],
                words_k.view(torch.int32)[:, lanes].view(torch.uint32),
                state_k[lanes], lane_rows[lanes], lanes.numel())

    def replay(self, rec, tag, max_rows=None):
        """``rec``'s words (the rows asked for) and state on each core's
        first and last lane block against the plain gang scan, bitwise;
        the kernel's device time at the launch's full shape, the plain
        scan's on those lanes, and the launch's bound.  ``max_rows`` runs
        the plain scan for that many word rows only: the words of those
        rows (they depend on no later step) and the state of the lanes
        whose rows end within them are held.  Returns (err, times)."""
        from repro_torch.kernels import ref
        torch, ops = self.torch, self.ops
        params, kw = rec["params"], rec["kw"]
        unit = kw["config"].compute_unit
        lattice, cpl = ops._lattice_args(params, unit)
        w = ops._stacked_weights(params)
        act = rec["activation"]
        x0, off, core_map, words_k, state_k, lane_rows, n_lanes_held = \
            self._subset(rec)
        n_rows = rec["n_steps"] // 2
        if max_rows is not None:
            n_rows = min(n_rows, max_rows)
        held = torch.clamp(lane_rows, max=n_rows)
        def plain():
            if core_map is None:        # K4: rows per core
                return ref.chaotic_ann_gang_stacked_ref(
                    *w, x0, 2 * n_rows, off, held[:, 0].tolist(), act,
                    lattice)
            # K3: each block's effective rows
            rows = held.reshape(len(core_map), -1)[:, 0].cpu().numpy()
            return ref.chaotic_ann_gang_bits_ref(
                *w, x0, core_map, 2 * n_rows, off, rows, act, lattice, unit,
                cpl)

        (words_p, state_p), plain_ms = timed_once(torch, plain)
        e = masked_err(torch, words_k[:n_rows], words_p, held)
        done = (lane_rows <= n_rows).reshape(-1)
        if bool(done.any()):
            e = max(e, max_abs_err(torch, state_k[done], state_p[done]))
        del words_p, state_p
        orig = self.orig[rec["f"]]
        args = (params, rec["x0"], rec["n_steps"], rec["word_offset"])
        t = {"ms": cuda_ms(torch, lambda: orig(*args, **kw), reps=10,
                           warmup=2), "plain_ms": plain_ms,
             "plain_lanes": n_lanes_held, "plain_rows": n_rows,
             "state_lanes": int(done.sum()) * (
                 n_lanes_held if core_map is None else 1)}
        x0 = rec["x0"]
        n_cores, i_dim, h_dim = params["w1"].shape
        n_lanes = x0.numel() // i_dim
        lane_rows = self.rows(rec)
        # K3's rows are per lane; K4's per core, for each of its lanes
        n_words = int(lane_rows.sum()) * (x0.shape[1] if x0.ndim == 3 else 1)
        item = x0.element_size()
        n_maps = n_cores if x0.ndim == 3 else 2 * len(kw["core_map"])
        # x0 read, state written, offsets (int64 in the scalar gangs,
        # uint32 in the others), weights (and the coupling operand on the
        # mxu) and maps read, the words computed written
        scalar = rec["kernel"] in SCALAR_GANG_WRAPPERS
        n_bytes = (2 * n_lanes * i_dim * item + n_lanes * (8 if scalar else 4)
                   + n_cores * (2 * i_dim * h_dim + h_dim + i_dim) * item
                   + n_maps * 4 + n_words * 4)
        extra = act_flops(h_dim, act)
        if unit == "mxu":   # FMA chains at the mxu rate (mxu_bound)
            n_bytes += i_dim * i_dim * item if lattice else 0
            mxu_step = mxu_step_flops(i_dim, h_dim, lattice, act)
            ops_step = sum(mxu_step)
            t["bound"] = mxu_bound(n_words * 2, mxu_step, n_bytes, tag)
        else:
            ops_step = (lattice_step_flops(lattice, h_dim, act) if lattice
                        else step_flops(i_dim, h_dim) + extra)
            t["bound"] = bound(n_words * 2 * (ops_step - extra), n_bytes,
                               tag, f32_flops=n_words * 2 * extra)
        t["ops_step"] = ops_step
        t["words"] = n_words
        t["hot_rows"] = int(lane_rows.max())
        return e, t


def replay_calls(torch, rec, tag, what, label, card, errs, times,
                 max_rows=None):
    """Every gang launch ``rec`` recorded in one flush against the plain
    gang scan on each core's first and last lane block (``max_rows``: its
    first word rows), bitwise, and timed at the flush's own shape (not
    counted as path launches); the times go to ``times[(kernel,
    activation, label)]``."""
    for r in rec.calls:
        e, t = rec.replay(r, tag, max_rows)
        name, act = r["kernel"], r["activation"]
        rows = rec.rows(r)
        print(f"check {what}: {name} {act} (x0 {tuple(r['x0'].shape)}, rows "
              f"{sorted(set(rows.flatten().tolist()))}) against the plain "
              f"gang scan on {t['plain_lanes']} lanes (each core's first "
              f"and last block), {t['plain_rows']} rows, the state of "
              f"{t['state_lanes']} lanes: max_abs_err={e}; {t['ms']:.4f} ms "
              f"(bound {t['bound'][0]:.4f} ms by {t['bound'][1]}, "
              f"{t['ops_step']} ops a step, {t['words']} words; plain "
              f"{t['plain_ms']:.1f} ms); card {card}")
        check(e == 0.0, f"{what}: {name} {act} != plain")
        errs[(name, act, tag)] = max(errs.get((name, act, tag), 0.0), e)
        times[(name, act, label)] = t


def check_gen_gang_kernels(torch, device, nets, errs) -> None:
    """tanh/sigmoid K3 (ragged rows) and K4 (a frozen core, a ragged lane
    count) against their plain versions, bitwise, in both dtypes: on the
    four trained 3-8-3 nets of an activation and on two seeded 4-16-4
    nets; K4 also at F1's shape with unequal demands.  Each net's words
    must differ from relu's."""
    from repro_torch.kernels import chaotic_ann, ref
    keys = ("w1", "b1", "w2", "b2")
    rng = np.random.default_rng(12)
    seeded = [rng.normal(0.0, s, (2,) + shape).astype(np.float32)
              for s, shape in ((0.5, (4, 16)), (0.1, (16,)),
                               (0.5, (16, 4)), (0.1, (4,)))]
    steps = GEN_CHECK_STEPS
    t0 = time.perf_counter()
    for act in PAPER_ACTIVATIONS:
        gangs = {"3-8": [np.stack([np.asarray(nets[(s, act)][0][k],
                                              np.float32)
                                   for s in GEN_SYSTEMS]) for k in keys],
                 "4-16": seeded}
        for gang, ws in gangs.items():
            w = [torch.as_tensor(a, device=device) for a in ws]
            n_cores, i_dim = w[0].shape[:2]
            n_lanes = GEN_CHECK_BLOCKS * GANG_S_BLOCK
            core_map = np.arange(GEN_CHECK_BLOCKS) % n_cores
            x0_np = rng.uniform(-0.9, 0.9, (n_lanes, i_dim)).astype(np.float32)
            off = torch.as_tensor(rng.integers(0, 1 << 32, n_lanes,
                                               dtype=np.int64), device=device)
            xs_np = rng.uniform(-0.9, 0.9, (n_cores, GEN_STACK_LANES, i_dim)
                                ).astype(np.float32)
            offs = torch.as_tensor(rng.integers(
                0, 1 << 32, (n_cores, GEN_STACK_LANES), dtype=np.int64),
                device=device)
            rows = chaotic_ann.gang_effective_rows(
                GEN_K3_ROW_MAP, steps, FARM_T_BLOCK, FARM_UNROLL)
            lane_rows = torch.as_tensor(
                np.repeat(rows, GANG_S_BLOCK).astype(np.int64), device=device)
            srow_map = GEN_K4_ROW_MAP[:n_cores]
            core_rows = torch.as_tensor(np.minimum(srow_map, steps // 2),
                                        device=device)[:, None]
            for dtype, tag in ((torch.float32, "f32"),
                               (torch.bfloat16, "bf16")):
                x0 = torch.as_tensor(x0_np, device=device).to(dtype)
                xs = torch.as_tensor(xs_np, device=device).to(dtype)
                kw = dict(n_steps=steps, s_block=GANG_S_BLOCK,
                          t_block=FARM_T_BLOCK, unroll=FARM_UNROLL)
                words_k, state_k = chaotic_ann.chaotic_ann_gang_bits(
                    *w, x0, core_map, off, GEN_K3_ROW_MAP, activation=act,
                    **kw)
                relu_k, _ = chaotic_ann.chaotic_ann_gang_bits(
                    *w, x0, core_map, off, GEN_K3_ROW_MAP, **kw)
                words_p, state_p = ref.chaotic_ann_gang_bits_ref(
                    *w, x0, core_map, steps, off, rows, act)
                e3 = max(masked_err(torch, words_k, words_p, lane_rows),
                         max_abs_err(torch, state_k, state_p))
                differs = masked_err(torch, words_k, relu_k, lane_rows) > 0
                words_k, state_k = chaotic_ann.chaotic_ann_gang_stacked(
                    *w, xs, offs, srow_map, n_steps=steps, activation=act)
                words_p, state_p = ref.chaotic_ann_gang_stacked_ref(
                    *w, xs, steps, offs, srow_map, act)
                e4 = max(masked_err(torch, words_k, words_p, core_rows),
                         max_abs_err(torch, state_k, state_p))
                torch.cuda.synchronize()
                print(f"check gang {act} {gang} {tag}: chaotic_ann_gang_bits "
                      f"(C={n_cores}, {GEN_CHECK_BLOCKS} blocks x "
                      f"{GANG_S_BLOCK} lanes, rows {sorted(set(rows.tolist()))}"
                      f") max_abs_err={e3}, words differ from relu's: "
                      f"{differs}; chaotic_ann_gang_stacked (C={n_cores} x "
                      f"{GEN_STACK_LANES} lanes, rows "
                      f"{np.minimum(srow_map, steps // 2).tolist()}) "
                      f"max_abs_err={e4}")
                check(e3 == 0.0 and e4 == 0.0,
                      f"{act} K3/K4 != plain ({gang}, {tag})")
                check(differs, f"{act} K3 words equal relu's ({gang}, {tag})"
                               f": the check cannot see a silent relu")
                for name, e in (("chaotic_ann_gang_bits", e3),
                                ("chaotic_ann_gang_stacked", e4)):
                    errs[(name, act, tag)] = max(
                        errs.get((name, act, tag), 0.0), e)
        # K4 at F1's shape (4 x 16,384 lanes, 128 rows) with unequal
        # demands: a frozen core's threads stop at its rows
        w = [torch.as_tensor(a, device=device) for a in gangs["3-8"]]
        n_lanes = FARM_CLIENTS * LANES_PER_CLIENT
        xs_np = rng.uniform(-0.9, 0.9, (4, n_lanes, 3)).astype(np.float32)
        offs = torch.as_tensor(rng.integers(0, 1 << 32, (4, n_lanes),
                                            dtype=np.int64), device=device)
        f1_steps = 2 * FARM_WORDS // LANES_PER_CLIENT
        core_rows = torch.as_tensor(np.minimum(GEN_F1_ROW_MAP, f1_steps // 2),
                                    device=device)[:, None]
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            xs = torch.as_tensor(xs_np, device=device).to(dtype)
            words_k, state_k = chaotic_ann.chaotic_ann_gang_stacked(
                *w, xs, offs, GEN_F1_ROW_MAP, n_steps=f1_steps,
                activation=act)
            words_p, state_p = ref.chaotic_ann_gang_stacked_ref(
                *w, xs, f1_steps, offs, GEN_F1_ROW_MAP, act)
            e = max(masked_err(torch, words_k, words_p, core_rows),
                    max_abs_err(torch, state_k, state_p))
            torch.cuda.synchronize()
            print(f"check gang {act} 3-8 {tag} at F1's shape: "
                  f"chaotic_ann_gang_stacked (4 x {n_lanes} lanes, rows "
                  f"{GEN_F1_ROW_MAP}) max_abs_err={e}")
            check(e == 0.0, f"{act} K4 != plain at F1's shape ({tag})")
            key = ("chaotic_ann_gang_stacked", act, tag)
            errs[key] = max(errs.get(key, 0.0), e)
    print(f"tanh/sigmoid gang kernel checks: {time.perf_counter() - t0:.1f} s")


def phase_gen_farm(torch, device, tag, card, farm_dir, errs, lattice=False):
    """Phase 11 for one dtype: the generated farm (relu, tanh and sigmoid
    3-8-3 cores on one config, hyperlorenz alone), 128 clients x 128 lanes
    a core; three flushes (F1 uniform: one K4 launch a group; F2 skewed:
    the chen cores hot; F3 one more client on each lorenz core: one K3
    launch a group), each with the launch counters zeroed just before it
    and read just after, held against a gang=False farm (solo K1 per
    core); every gang launch of the flushes against the plain gang scan
    on its inputs, bitwise; one gang group per activation.  With
    ``lattice`` phase 12's farm of ring8 lattice cores likewise, through
    the lattice forms (no solo core; F2's chen cores draw LATTICE_WORDS).
    Returns ({(kernel, activation): launches}, {(kernel, activation,
    flush): times}, flush walls, {flush: profile split ms})."""
    from repro_torch.serve.farm import _compat_key
    names = GangRecorder.LATTICE_NAMES if lattice else GangRecorder.NAMES
    k3, k4 = names["chaotic_bits_gang"], names["chaotic_bits_gang_stacked"]
    k1 = kernel_names(lattice)[0]
    what = "lattice generated farm" if lattice else "generated farm"
    solo_want = [] if lattice else ["hyperlorenz"]
    farm = gen_farm(torch, device, farm_dir, tag)
    solo = gen_farm(torch, device, farm_dir, tag, gang=False)
    cores = farm.cores
    groups = {}
    for c in cores:
        groups.setdefault(_compat_key(farm.services[c]), []).append(c)
    by_act = {farm.services[g[0]].activation: sorted(g)
              for g in groups.values() if len(g) > 1}
    solos = sorted(g[0] for g in groups.values() if len(g) == 1)
    print(f"{what} {tag}: {len(cores)} cores; gang groups "
          f"{by_act}; alone {solos}; config "
          f"{farm.services[cores[0]].config}")
    check(sorted(by_act) == ["relu", "sigmoid", "tanh"]
          and all(len(g) == len(GEN_SYSTEMS) for g in by_act.values())
          and all(farm.services[c].activation == a
                  for a, g in by_act.items() for c in g)
          and solos == solo_want,
          f"{what} {tag}: expected one group of {len(GEN_SYSTEMS)} per "
          f"activation and {solo_want} alone")
    clients = [f"c{i:03d}" for i in range(FARM_CLIENTS)]
    t_register = register_all(torch, (farm, solo), clients, 7000)
    hot_words = LATTICE_WORDS if lattice else HOT_WORDS
    hot = {c: hot_words if c.startswith(GEN_HOT) else COLD_WORDS
           for c in cores}
    flushes = (("F1", {c: FARM_WORDS for c in cores}), ("F2", hot),
               ("F3", {c: FARM_WORDS for c in cores}))
    path, times, walls, splits = {}, {}, {}, {}
    for label, words in flushes:
        if label == "F3":                  # unequal pools: one more client
            for f in (farm, solo):
                for c in cores:
                    if c.startswith(GEN_F3):
                        f.register(c, f"c{FARM_CLIENTS}", seed=99)
        request_all((farm, solo), words)
        prof0 = farm.profile_stats
        with GangRecorder(torch) as rec:
            _, got, decisions, _, n_launched, walls[label] = counted_flush(
                torch, farm, solo, f"{what} {tag} {label}", card)
        splits[label] = {k: (v - prof0[k]) * 1e3
                         for k, v in farm.profile_stats.items()
                         if k != "flushes"}
        acts = {}
        for r in rec.calls:
            acts.setdefault(r["kernel"], []).append(r["activation"])
            key = (r["kernel"], r["activation"])
            path[key] = path.get(key, 0) + r["launches"]
        print(f"{what} {tag} {label}: gang launches by activation "
              f"{ {k: sorted(v) for k, v in acts.items()} }")
        check(all(r["launches"] == 1 for r in rec.calls)
              and got[k3] + got[k4] == len(rec.calls),
              f"{what} {tag} {label}: each gang call must count one "
              f"launch ({got}, {len(rec.calls)} calls)")
        check(all(v == 0 for k, v in got.items() if k not in (k3, k4, k1)),
              f"{what} {tag} {label}: a kernel of another form "
              f"launched ({got})")
        one_each = ["relu", "sigmoid", "tanh"]
        if label == "F1":
            check(decisions == {"padded": 3}
                  and sorted(acts.get(k4, [])) == one_each and got[k3] == 0
                  and got[k1] == len(solo_want)
                  and n_launched == 3 + len(solo_want),
                  f"{what} {tag} F1: expected one padded K4 launch an "
                  f"activation and {len(solo_want)} K1, got {decisions} "
                  f"{got}")
        elif label == "F2":
            check("padded" not in decisions
                  and got[k3] + got[k4] + got[k1] > 0,
                  f"{what} {tag} F2: expected ragged or split, got "
                  f"{decisions} {got}")
        else:
            check(decisions == {"padded": 3}
                  and sorted(acts.get(k3, [])) == one_each and got[k4] == 0
                  and got[k1] == len(solo_want),
                  f"{what} {tag} F3: expected one padded K3 launch an "
                  f"activation and {len(solo_want)} K1, got {decisions} "
                  f"{got}")
        replay_calls(torch, rec, tag, f"{what} {tag} {label}", label, card,
                     errs, times, max_rows=GEN_REPLAY_ROWS)
        del rec
    for name in (k3, k4):
        for act in ("relu",) + PAPER_ACTIVATIONS:
            check(path.get((name, act), 0) > 0,
                  f"{name} {act} not launched on the {tag} {what}")
    print(f"{what} {tag}: {len(cores)} cores x {FARM_CLIENTS} "
          f"clients x {LANES_PER_CLIENT} lanes; register {t_register:.3f} s "
          f"per farm; every flush bitwise equal to the gang=False farm; "
          f"walls ms " + ", ".join(f"{k} {v * 1e3:.1f}"
                                   for k, v in walls.items()))
    return path, times, walls, splits


def gang_act_rows(names, tag, path_name, path, times, walls, splits, errs,
                  form):
    """The ``kernels`` rows of tanh/sigmoid K4 (at F1) and K3 (at F3, each
    padded, one launch a group), with F2's (ragged) times where K3/K4 ran
    there, each beside relu's launch of the same flush."""
    rows = []
    for name, flush in ((names["chaotic_bits_gang_stacked"], "F1"),
                        (names["chaotic_bits_gang"], "F3")):
        for act in PAPER_ACTIVATIONS:
            t = times[(name, act, flush)]
            row = {
                "name": f"{name}/{act}/{tag}", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/chaotic_ann.cu",
                "replaces": REPLACES[name], "path": path_name,
                "launches": path[(name, act)],
                "max_abs_err": errs[(name, act, tag)],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "plain_lanes": t["plain_lanes"],
                "plain_rows": t["plain_rows"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": None, "shape": f"{flush} padded",
                "ops_step": t["ops_step"],
                "relu_ms": times[(name, "relu", flush)]["ms"],
                "flush_wall_ms": {k: v * 1e3 for k, v in walls.items()},
                "flush_split_ms": splits, "form": form(act),
            }
            if tag == "bf16" and name in BF16X2_GANG_X2_KERNELS:
                row["kernel"] = BF16X2_GANG_X2_KERNELS[name]
            elif tag == "f32" and name in F32_GANG_KERNELS:
                row["kernel"] = F32_GANG_KERNELS[name]
            f2 = times.get((name, act, "F2"))
            if f2:
                row.update(ms_f2=f2["ms"], plain_ms_f2=f2["plain_ms"],
                           bound_ms_f2=f2["bound"][0],
                           relu_ms_f2=times[(name, "relu", "F2")]["ms"],
                           f2_hot_rows=f2["hot_rows"])
            rows.append(row)
    return rows


def phase_generated_farm(torch, device, card, chen_nets, errs):
    """Phase 11: the nets, the farm directory, the tanh/sigmoid K3/K4
    checks, then the farm path per dtype.  Returns the ``kernels`` rows
    of tanh and sigmoid K3/K4, and the 3-8-3 nets {(system, activation):
    (numpy bundle, scale, offset)}."""
    import tempfile
    nets = train_gen_nets(torch, device, card, chen_nets)
    check_gen_gang_kernels(torch, device, nets, errs)
    rows = []
    with tempfile.TemporaryDirectory(prefix="generated_farm_") as tmp:
        write_gen_dir(tmp, nets)
        for tag in ("f32", "bf16"):
            path, times, walls, splits = phase_gen_farm(
                torch, device, tag, card, tmp, errs)
            rows += gang_act_rows(
                GangRecorder.NAMES, tag, "generated-farm", path, times,
                walls, splits, errs,
                lambda act: (f"vpu scalar, {act} (_activation, "
                             f"src/repro/kernels/chaotic_ann.py:44-45)"))
    return rows, nets


# ---------------------------------------------------------------------------
# Phase 12: lattices of tanh and sigmoid nets
# ---------------------------------------------------------------------------

def expand_net(net, system):
    """A trained 3-8-3 net ``(numpy bundle, scale, offset)`` as the lattice
    ``system`` (``<base>@<ring|grid><n>``): ``expand_lattice_params`` at
    the default coupling, and the normalizer tiled per node."""
    from repro_torch.core.ann import expand_lattice_params
    from repro_torch.core.chaotic import (DEFAULT_LATTICE_COUPLING,
                                          parse_lattice_name)
    bundle, scale, offset = net
    _, topology, n_nodes = parse_lattice_name(system)
    return (expand_lattice_params(bundle, n_nodes=n_nodes,
                                  coupling=DEFAULT_LATTICE_COUPLING,
                                  topology=topology),
            np.tile(scale, n_nodes), np.tile(offset, n_nodes))


def check_lattice_act_kernels(torch, device, nets, errs) -> None:
    """tanh/sigmoid lattice K1, K2 (on chen's expansion), K3 (ragged rows)
    and K4 (a ragged lane count, unequal demands) against their plain
    versions, bitwise, in both dtypes, at every LATTICE_SHAPES entry, on
    expansions of the four trained nets of an activation; each kernel's
    words must differ from relu's on the same weights."""
    from repro_torch.core.ann import lattice_meta_tuple
    from repro_torch.core.chaotic import parse_lattice_name
    from repro_torch.kernels import chaotic_ann, ops, ref
    keys = ("w1", "b1", "w2", "b2")
    rng = np.random.default_rng(13)
    n_lanes = LATTICE_GANG_BLOCKS * LATTICE_GANG_S_BLOCK
    core_map = np.arange(LATTICE_GANG_BLOCKS) % len(GEN_SYSTEMS)
    t0 = time.perf_counter()
    for act in PAPER_ACTIVATIONS:
        for system in LAT_ACT_SHAPES:
            n_nodes = parse_lattice_name(system)[2]
            per_core = [expand_net(nets[(s, act)], system)[0]
                        for s in GEN_SYSTEMS]
            w = [torch.as_tensor(np.stack([p[k] for p in per_core]),
                                 device=device) for k in keys]
            lattice = lattice_meta_tuple(per_core[0]["lattice_meta"])
            i_dim = w[0].shape[1]
            steps = LAT_ACT_STEPS[n_nodes]
            rows = chaotic_ann.gang_effective_rows(
                LATTICE_K3_ROW_MAP, steps, FARM_T_BLOCK, FARM_UNROLL)
            lane_rows = torch.as_tensor(np.repeat(
                rows, LATTICE_GANG_S_BLOCK).astype(np.int64), device=device)
            srows = np.minimum(LATTICE_K4_ROW_MAP, steps // 2)
            core_rows = torch.as_tensor(srows.astype(np.int64),
                                        device=device)[:, None]
            x1_np = rng.uniform(-0.9, 0.9, (LATTICE_CHECK_LANES, i_dim)
                                ).astype(np.float32)
            off1 = torch.as_tensor(rng.integers(
                0, 1 << 32, LATTICE_CHECK_LANES, dtype=np.int64),
                device=device)
            x0_np = rng.uniform(-0.9, 0.9, (n_lanes, i_dim)).astype(np.float32)
            off = torch.as_tensor(rng.integers(0, 1 << 32, n_lanes,
                                               dtype=np.int64), device=device)
            xs_np = rng.uniform(-0.9, 0.9, (4, LATTICE_STACK_LANES, i_dim)
                                ).astype(np.float32)
            offs = torch.as_tensor(rng.integers(
                0, 1 << 32, (4, LATTICE_STACK_LANES), dtype=np.int64),
                device=device)
            for dtype, tag in ((torch.float32, "f32"),
                               (torch.bfloat16, "bf16")):
                e, differs = {}, {}
                x1 = torch.as_tensor(x1_np, device=device).to(dtype)
                w1 = [a[0] for a in w]
                kw = dict(n_steps=steps, lattice=lattice)
                words_k, state_k = chaotic_ann.chaotic_ann_bits(
                    *w1, x1, off1, activation=act, **kw)
                traj_k = chaotic_ann.chaotic_ann_traj(*w1, x1,
                                                      activation=act, **kw)
                relu_k, _ = chaotic_ann.chaotic_ann_bits(*w1, x1, off1, **kw)
                traj_p = ref.chaotic_ann_ref(*w1, x1, steps, act, lattice)
                e["chaotic_ann_lattice_bits"] = max(
                    max_abs_err(torch, words_k, ops.pack_words(traj_p, off1)),
                    max_abs_err(torch, state_k, traj_p[-1]))
                e["chaotic_ann_lattice_traj"] = max_abs_err(torch, traj_k,
                                                            traj_p)
                differs["K1"] = max_abs_err(torch, words_k, relu_k) > 0
                del traj_k, traj_p
                x0 = torch.as_tensor(x0_np, device=device).to(dtype)
                gkw = dict(n_steps=steps, s_block=LATTICE_GANG_S_BLOCK,
                           t_block=FARM_T_BLOCK, unroll=FARM_UNROLL,
                           lattice=lattice)
                words_k, state_k = chaotic_ann.chaotic_ann_gang_bits(
                    *w, x0, core_map, off, LATTICE_K3_ROW_MAP,
                    activation=act, **gkw)
                relu_k, _ = chaotic_ann.chaotic_ann_gang_bits(
                    *w, x0, core_map, off, LATTICE_K3_ROW_MAP, **gkw)
                words_p, state_p = ref.chaotic_ann_gang_bits_ref(
                    *w, x0, core_map, steps, off, rows, act, lattice)
                e["chaotic_ann_lattice_gang_bits"] = max(
                    masked_err(torch, words_k, words_p, lane_rows),
                    max_abs_err(torch, state_k, state_p))
                differs["K3"] = masked_err(torch, words_k, relu_k,
                                           lane_rows) > 0
                xs = torch.as_tensor(xs_np, device=device).to(dtype)
                words_k, state_k = chaotic_ann.chaotic_ann_gang_stacked(
                    *w, xs, offs, LATTICE_K4_ROW_MAP, n_steps=steps,
                    lattice=lattice, activation=act)
                relu_k, _ = chaotic_ann.chaotic_ann_gang_stacked(
                    *w, xs, offs, LATTICE_K4_ROW_MAP, n_steps=steps,
                    lattice=lattice)
                words_p, state_p = ref.chaotic_ann_gang_stacked_ref(
                    *w, xs, steps, offs, LATTICE_K4_ROW_MAP, act, lattice)
                e["chaotic_ann_lattice_gang_stacked"] = max(
                    masked_err(torch, words_k, words_p, core_rows),
                    max_abs_err(torch, state_k, state_p))
                differs["K4"] = masked_err(torch, words_k, relu_k,
                                           core_rows) > 0
                torch.cuda.synchronize()
                print(f"check lattice {act} {system} {tag} (steps={steps}; "
                      f"K1/K2 S={LATTICE_CHECK_LANES}; K3 C=4, "
                      f"{LATTICE_GANG_BLOCKS} blocks x "
                      f"{LATTICE_GANG_S_BLOCK} lanes, rows "
                      f"{sorted(set(rows.tolist()))}; K4 C=4 x "
                      f"{LATTICE_STACK_LANES} lanes, rows {srows.tolist()}): "
                      + ", ".join(f"{k} max_abs_err={v}" for k, v in e.items())
                      + f"; words differ from relu's: {differs}")
                for name, err in e.items():
                    check(err == 0.0, f"{act} {name} != plain ({system}, "
                                      f"{tag})")
                    errs[(name, act, tag)] = max(
                        errs.get((name, act, tag), 0.0), err)
                check(all(differs.values()),
                      f"{act} lattice words equal relu's ({system}, {tag}, "
                      f"{differs}): the check cannot see a silent relu")
    print(f"tanh/sigmoid lattice kernel checks: "
          f"{time.perf_counter() - t0:.1f} s")


def counted_path(torch, fn, want, what):
    """``fn()`` with the launch counters zeroed just before and read just
    after: it must launch every kernel of ``want`` (a name, or a set of
    names) and no other.  Returns (its result, {kernel: launches})."""
    from repro_torch.kernels import chaotic_ann
    want = {want} if isinstance(want, str) else set(want)
    zero_launches(chaotic_ann)
    out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in read_launches(chaotic_ann).items() if v}
    check(set(got) == want,
          f"{what}: the path must launch {sorted(want)} only, got {got}")
    return out, got


def lattice_act_paths(torch, device, nets):
    """Phase 12's paths for one activation each: the no-config f32
    ``ChaoticStream`` of the chen@ring8 lattice (lattice K1; its config
    held to the JAX package's; 2**20 words, the first
    LAT_STREAM_CHECK_WORDS bitwise against ``backend="ref"``; the NIST
    subset printed), the lattice iterated on the card (lattice K2, f32),
    and the generated chen@ring8 / chen@grid8 cores on the "pareto"
    candidate (held to the JAX one): each testbench on the card in its
    own process, each core's ``generate`` (lattice K2) and
    ``generate_bits`` (lattice K1), bf16, bitwise against ``backend="ref"``
    on the card.  Returns {(kernel, activation, dtype tag): launches}."""
    import importlib
    import tempfile
    from repro_torch.core.ann import params_from_numpy
    from repro_torch.core.codegen import generate_core
    from repro_torch.core.dse import Candidate, select
    from repro_torch.kernels import ops
    from repro_torch.prng.stream import ChaoticStream

    launches, path_out = {}, {}
    cand = select(24, 64, "pareto", n_nodes=8)
    print(f"lattice cores: select(24, 64, 'pareto', n_nodes=8) = {cand}")
    check(cand == Candidate(**LAT_SELECT),
          f"select(24, 64, 'pareto', n_nodes=8): {cand} is not the JAX "
          f"package's")
    tmp = tempfile.TemporaryDirectory(prefix="lattice_cores_")
    sys.path.insert(0, tmp.name)
    try:
        pkgs = []
        for act in PAPER_ACTIVATIONS:
            for system in LAT_CORES:
                params, scale, offset = expand_net(nets[("chen", act)],
                                                   system)
                pkgs.append(generate_core(
                    f"{system.replace('@', '_')}_{act}", tmp.name,
                    params=params, candidate=cand, system=system,
                    activation=act, scale=scale, offset=offset))
        t0 = time.perf_counter()
        run_testbenches(pkgs)
        print(f"lattice cores: {len(pkgs)} testbenches "
              f"{time.perf_counter() - t0:.1f} s")
        for act in PAPER_ACTIVATIONS:
            params = expand_net(nets[("chen", act)], "chen@ring8")[0]
            stream = ChaoticStream.from_trained(params, activation=act,
                                                device=device)
            cfg = stream._engine.config
            print(f"lattice stream {act}: chen@ring8 with no config -> "
                  f"{cfg}")
            check(cfg == Candidate(**LAT_STREAM_CONFIG),
                  f"lattice stream {act}: config {cfg} is not the JAX "
                  f"package's select_config")
            words, n = counted_path(
                torch, lambda: stream.bits(NIST_WORDS).numpy(),
                "chaotic_ann_lattice_bits", f"lattice stream {act}")
            launches[("chaotic_ann_lattice_bits", act, "f32")] = \
                n["chaotic_ann_lattice_bits"]
            plain = ChaoticStream.from_trained(
                params, activation=act, device=device, backend="ref")
            path_out[(act, "stream words")] = (
                words[:LAT_STREAM_CHECK_WORDS],
                plain.bits(LAT_STREAM_CHECK_WORDS).numpy())
            p, failed = nist3(words)
            print(f"nist lattice {act} chen@ring8 on {words.size} words of "
                  f"ChaoticStream.from_trained (not gated): "
                  + ", ".join(f"{k} p={v:.4g}" for k, v in p.items())
                  + f"; under alpha {NIST_ALPHA}: {failed}")
            p_dev = params_from_numpy(params, device=device)
            x_att = torch.as_tensor(np.random.default_rng(14).uniform(
                -0.5, 0.5, (ATTRACTOR_LANES, 24)).astype(np.float32),
                device=device)
            traj, n = counted_path(torch, lambda: ops.chaotic_trajectory(
                p_dev, x_att, LAT_ATTRACTOR_STEPS, activation=act),
                "chaotic_ann_lattice_traj", f"lattice {act} iterated")
            launches[("chaotic_ann_lattice_traj", act, "f32")] = \
                n["chaotic_ann_lattice_traj"]
            amax = float(traj.abs().max())
            print(f"lattice {act}: chen@ring8 iterated {LAT_ATTRACTOR_STEPS} "
                  f"steps on {ATTRACTOR_LANES} lanes: max|x| {amax:.4g}, std "
                  f"of the last 500 {float(traj[-500:].std()):.4g}")
            check(bool(torch.isfinite(traj).all()) and amax < 10.0,
                  f"lattice {act}: the expanded net leaves the attractor box")
            path_out[(act, "iterated lattice")] = (
                traj, ops.chaotic_trajectory(p_dev, x_att,
                                             LAT_ATTRACTOR_STEPS,
                                             activation=act, backend="ref"))
            for system in LAT_CORES:
                name = f"{system.replace('@', '_')}_{act}"
                core = importlib.import_module(name)
                x0 = np.random.default_rng(15).uniform(
                    -0.5, 0.5, (core.S_BLOCK, 24)).astype(np.float32)
                got, n = counted_path(
                    torch, lambda: core.generate(x0, LAT_CORE_STEPS,
                                                 device=device),
                    "chaotic_ann_lattice_traj", f"core {name} generate")
                key = ("chaotic_ann_lattice_traj", act, "bf16")
                launches[key] = launches.get(key, 0) + n[key[0]]
                path_out[(act, f"{name} generate")] = (got, core.generate(
                    x0, LAT_CORE_STEPS, backend="ref", device=device))
                got, n = counted_path(
                    torch, lambda: core.generate_bits(
                        x0, 2 * LAT_CORE_STEPS, device=device),
                    "chaotic_ann_lattice_bits", f"core {name} generate_bits")
                key = ("chaotic_ann_lattice_bits", act, "bf16")
                launches[key] = launches.get(key, 0) + n[key[0]]
                path_out[(act, f"{name} generate_bits")] = (
                    got, core.generate_bits(x0, 2 * LAT_CORE_STEPS,
                                            backend="ref", device=device))
                sys.modules.pop(name, None)
        for (act, what), (got, want) in path_out.items():
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            e = max(max_abs_err(torch, torch.as_tensor(g), torch.as_tensor(w))
                    for g, w in zip(got, want))
            print(f"check lattice {act} path: {what} "
                  f"{tuple(np.shape(got[0]))} against the plain path: "
                  f"max_abs_err={e}")
            check(e == 0.0, f"lattice {act} path: {what} != plain")
    finally:
        sys.path.remove(tmp.name)
        tmp.cleanup()
    return launches


def lattice_act_times(torch, device, card, nets, errs):
    """tanh/sigmoid lattice K1 and K2 at chen@ring8, LAT_TIME_LANES x
    LAT_TIME_STEPS, against one plain run, bitwise, then their device
    times beside relu's on the same weights and inputs, the plain times
    and the bounds; at chen@ring32 the kernels' times alone (relu beside
    them), beside the lattice path's ring32 times.  Returns {(act,
    system, tag): times}."""
    from repro_torch.core.ann import lattice_meta_tuple
    from repro_torch.kernels import chaotic_ann, ops, ref
    keys = ("w1", "b1", "w2", "b2")
    n, steps = LAT_TIME_LANES, LAT_TIME_STEPS
    rng = np.random.default_rng(16)
    off_np = rng.integers(0, 1 << 32, n, dtype=np.int64)
    off_np[:64] = (1 << 32) - 1 - 3 * np.arange(64)     # wrap mid-run
    off = torch.as_tensor(off_np, device=device)
    out = {}
    for act in PAPER_ACTIVATIONS:
        for system in ("chen@ring8", "chen@ring32"):
            params = expand_net(nets[("chen", act)], system)[0]
            w = [torch.as_tensor(params[k], device=device) for k in keys]
            lattice = lattice_meta_tuple(params["lattice_meta"])
            i_dim, h_dim = params["w1"].shape
            x_np = rng.uniform(-0.9, 0.9, (n, i_dim)).astype(np.float32)
            for dtype, tag in ((torch.float32, "f32"),
                               (torch.bfloat16, "bf16")):
                x = torch.as_tensor(x_np, device=device).to(dtype)
                kw = dict(n_steps=steps, lattice=lattice)
                t = {}
                if system == "chen@ring8":
                    traj_p, t["traj_plain_ms"] = timed_once(
                        torch, lambda: ref.chaotic_ann_ref(*w, x, steps, act,
                                                           lattice))
                    words_p, pack_ms = timed_once(
                        torch, lambda: ops.pack_words(traj_p, off))
                    t["bits_plain_ms"] = t["traj_plain_ms"] + pack_ms
                    words_k, state_k = chaotic_ann.chaotic_ann_bits(
                        *w, x, off, activation=act, **kw)
                    e_bits = max(max_abs_err(torch, words_k, words_p),
                                 max_abs_err(torch, state_k, traj_p[-1]))
                    e_traj = max_abs_err(torch, chaotic_ann.chaotic_ann_traj(
                        *w, x, activation=act, **kw), traj_p)
                    del traj_p, words_p, words_k
                    print(f"check lattice {act} {system} {tag} S={n} "
                          f"steps={steps}: chaotic_ann_lattice_bits "
                          f"max_abs_err={e_bits} chaotic_ann_lattice_traj "
                          f"max_abs_err={e_traj}")
                    check(e_bits == 0.0 and e_traj == 0.0,
                          f"{act} lattice K1/K2 != plain at {system} ({tag})")
                    for name, e in (("chaotic_ann_lattice_bits", e_bits),
                                    ("chaotic_ann_lattice_traj", e_traj)):
                        errs[(name, act, tag)] = max(
                            errs.get((name, act, tag), 0.0), e)
                t["bits_ms"] = cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_bits(
                    *w, x, off, activation=act, **kw), reps=5, warmup=2)
                t["relu_bits_ms"] = cuda_ms(
                    torch, lambda: chaotic_ann.chaotic_ann_bits(
                        *w, x, off, **kw), reps=5, warmup=2)
                t["traj_ms"] = cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_traj(
                    *w, x, activation=act, **kw), reps=3, warmup=1)
                t["relu_traj_ms"] = cuda_ms(
                    torch, lambda: chaotic_ann.chaotic_ann_traj(*w, x, **kw),
                    reps=3, warmup=1)
                item = x.element_size()
                ops_step = lattice_step_flops(lattice, h_dim, act)
                extra = act_flops(h_dim, act)
                # the block-sparse weights (each node's blocks) read once
                weight_bytes = (2 * i_dim * h_dim // lattice[0] + h_dim
                                + i_dim) * item
                n_out = steps // 2 * n
                t["bits_bound"] = bound(
                    n_out * 2 * (ops_step - extra),
                    2 * n * i_dim * item + n * 4 + weight_bytes + n_out * 4,
                    tag, f32_flops=n_out * 2 * extra)
                t["traj_bound"] = bound(
                    steps * n * (ops_step - extra),
                    n * i_dim * item + weight_bytes
                    + steps * n * i_dim * item, tag,
                    f32_flops=steps * n * extra)
                t["ops_step"] = ops_step
                out[(act, system, tag)] = t
                print(f"device times lattice {act} {system} {tag} (S={n}, "
                      f"n_steps={steps}, {ops_step} ops a step): "
                      f"chaotic_ann_lattice_bits {t['bits_ms']:.4f} ms "
                      f"(relu's {t['relu_bits_ms']:.4f} ms in this call; "
                      f"bound {t['bits_bound'][0]:.4f} ms by "
                      f"{t['bits_bound'][1]}); chaotic_ann_lattice_traj "
                      f"{t['traj_ms']:.4f} ms (relu's {t['relu_traj_ms']:.4f}"
                      f" ms; bound {t['traj_bound'][0]:.4f} ms by "
                      f"{t['traj_bound'][1]})"
                      + (f"; plain {t['bits_plain_ms']:.1f} / "
                         f"{t['traj_plain_ms']:.1f} ms"
                         if "bits_plain_ms" in t else "")
                      + f"; card {card}")
    return out


def write_lat_dir(farm_dir, nets) -> None:
    """``generate_farm`` of the four ring8 lattices (relu, registry
    weights) and ``<system>_ring8_<activation>`` for each trained net
    expanded to chen@ring8's descriptor, on ``select(24, 64, "pareto",
    n_nodes=8)``; every ``Candidate`` held to the JAX package's."""
    from repro_torch.core.codegen import generate_core, generate_farm
    from repro_torch.core.dse import Candidate, select
    for name, pkg in generate_farm(
            farm_dir, [f"{s}@ring8" for s in GEN_SYSTEMS]).items():
        cand = Candidate(**json.loads(
            (pkg / "solution.json").read_text())["candidate"])
        print(f"lattice generated farm: generate_farm {name}: {cand}")
        check(cand == Candidate(**LAT_SELECT),
              f"generate_farm {name}: {cand} is not the JAX package's")
    cand = select(24, 64, "pareto", n_nodes=8)
    for (system, act), net in sorted(nets.items()):
        params, scale, offset = expand_net(net, f"{system}@ring8")
        generate_core(f"{system}_ring8_{act}", farm_dir, params=params,
                      candidate=cand, system=f"{system}@ring8",
                      activation=act, scale=scale, offset=offset)


def phase_lattice_activations(torch, device, card, nets, errs):
    """Phase 12: the tanh/sigmoid lattice K1-K4 checks, the stream, the
    iterated lattice and the generated cores, the lattice farm of
    generated relu, tanh and sigmoid ring8 cores per dtype, and the
    lattice K1/K2 times.  Returns the ``kernels`` rows of tanh and sigmoid
    lattice K1-K4."""
    import tempfile
    t0 = time.perf_counter()
    check_lattice_act_kernels(torch, device, nets, errs)
    t1 = time.perf_counter()
    launches = lattice_act_paths(torch, device, nets)
    t2 = time.perf_counter()
    rows = []
    with tempfile.TemporaryDirectory(prefix="lattice_farm_") as tmp:
        write_lat_dir(tmp, nets)
        for tag in ("f32", "bf16"):
            path, times, walls, splits = phase_gen_farm(
                torch, device, tag, card, tmp, errs, lattice=True)
            rows += gang_act_rows(
                GangRecorder.LATTICE_NAMES, tag, "lattice-generated-farm",
                path, times, walls, splits, errs,
                lambda act: (f"chen@ring8 vpu lattice, {act} (_activation "
                             f"src/repro/kernels/chaotic_ann.py:44-45 with "
                             f"K5 :61)"))
    t3 = time.perf_counter()
    times = lattice_act_times(torch, device, card, nets, errs)
    for (name, act, tag), n in sorted(launches.items()):
        key = "bits" if name == "chaotic_ann_lattice_bits" else "traj"
        t, t32 = times[(act, "chen@ring8", tag)], times[(act, "chen@ring32",
                                                          tag)]
        rows.append({
            "name": f"{name}/{act}/{tag}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chaotic_ann.cu",
            "replaces": REPLACES[f"chaotic_ann_{key}"],
            "path": ("lattice-stream" if tag == "f32" and key == "bits"
                     else "lattice-iterated" if tag == "f32"
                     else "lattice-generated-cores"),
            "launches": n, "max_abs_err": errs[(name, act, tag)],
            "ms": t[f"{key}_ms"], "plain_ms": t[f"{key}_plain_ms"],
            "bound_ms": t[f"{key}_bound"][0],
            "bound_by": t[f"{key}_bound"][1], "library_ms": None,
            "shape": f"chen@ring8, {LAT_TIME_LANES} lanes x "
                     f"{LAT_TIME_STEPS} steps",
            "ops_step": t["ops_step"], "relu_ms": t[f"relu_{key}_ms"],
            "ring32_ms": t32[f"{key}_ms"],
            "ring32_relu_ms": t32[f"relu_{key}_ms"],
            "ring32_bound_ms": t32[f"{key}_bound"][0],
            "form": (f"vpu lattice, {act} (_activation "
                     f"src/repro/kernels/chaotic_ann.py:44-45 with K5 :61)"),
        })
        if tag == "bf16" and name in BF16X2_LATTICE_KERNELS:
            rows[-1]["kernel"] = BF16X2_LATTICE_KERNELS[name]
    print(f"lattice activations: kernel checks {t1 - t0:.1f} s, paths "
          f"{t2 - t1:.1f} s, farms {t3 - t2:.1f} s, times "
          f"{time.perf_counter() - t3:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 13: tanh and sigmoid in the mxu forms of K1-K3
# ---------------------------------------------------------------------------

def mxu_act_operands(torch, device, nets, act, shape):
    """The stacked weights on the card of one of MXU_GANG_CHECKS for
    ``act``, its lattice descriptor and its one shared coupling operand
    (None, None for a scalar gang): the four 3-8-3 nets of the activation
    (GEN_SYSTEMS), expanded to the lattice for a lattice shape; at 4-16
    two seeded nets (no 4-16 net is trained)."""
    from repro_torch.core.ann import lattice_meta_tuple
    keys = ("w1", "b1", "w2", "b2")
    if shape == "4-16":
        rng = np.random.default_rng(18)
        ws = [rng.normal(0.0, sd, (2,) + dims).astype(np.float32)
              for sd, dims in ((0.5, (4, 16)), (0.1, (16,)),
                               (0.5, (16, 4)), (0.1, (4,)))]
        return [torch.as_tensor(a, device=device) for a in ws], None, None
    if shape == "3-8":
        per_core = [nets[(s, act)][0] for s in GEN_SYSTEMS]
    else:
        per_core = [expand_net(nets[(s, act)], shape)[0] for s in GEN_SYSTEMS]
    w = [torch.as_tensor(np.stack([np.asarray(p[k], np.float32)
                                   for p in per_core]), device=device)
         for k in keys]
    if shape == "3-8":
        return w, None, None
    return (w, lattice_meta_tuple(per_core[0]["lattice_meta"]),
            torch.as_tensor(per_core[0]["coupling"], device=device))


def check_mxu_act_kernels(torch, device, nets, errs) -> None:
    """tanh/sigmoid mxu K1, K2 (on the first net, a ragged lane count) and
    K3 (phase_mxu_gang_kernels' blocks, steps and ragged rows, padded and
    ragged) against their plain versions, bitwise, in both dtypes, at
    every MXU_SHAPES entry; each kernel's words must differ from relu's on
    the same weights."""
    from repro_torch.kernels import chaotic_ann, ops, ref
    rng = np.random.default_rng(19)
    n_lanes = MXU_GANG_BLOCKS * MXU_GANG_S_BLOCK
    t0 = time.perf_counter()
    for act in PAPER_ACTIVATIONS:
        for shape in MXU_GANG_CHECKS:
            w, lattice, cpl = mxu_act_operands(torch, device, nets, act,
                                               shape)
            n_cores, i_dim = w[0].shape[:2]
            n_nodes = lattice[0] if lattice else 1
            lanes1, steps1 = MXU_ACT_CHECKS[n_nodes]
            steps = MXU_GANG_STEPS[n_nodes]
            core_map = np.arange(MXU_GANG_BLOCKS) % n_cores
            x1_np = rng.uniform(-0.9, 0.9, (lanes1, i_dim)).astype(np.float32)
            off1_np = rng.integers(0, 1 << 32, lanes1, dtype=np.int64)
            n_wrap = min(64, lanes1)                # wrap mid-run
            off1_np[:n_wrap] = (1 << 32) - 1 - 3 * np.arange(n_wrap)
            off1 = torch.as_tensor(off1_np, device=device)
            x0_np = rng.uniform(-0.9, 0.9, (n_lanes, i_dim)).astype(np.float32)
            off = torch.as_tensor(rng.integers(0, 1 << 32, n_lanes,
                                               dtype=np.int64), device=device)
            kw = dict(lattice=lattice, compute_unit="mxu", coupling=cpl)
            for dtype, tag in ((torch.float32, "f32"),
                               (torch.bfloat16, "bf16")):
                e, differs = {}, {}
                x1 = torch.as_tensor(x1_np, device=device).to(dtype)
                w1 = [a[0] for a in w]
                words_k, state_k = chaotic_ann.chaotic_ann_bits(
                    *w1, x1, off1, n_steps=steps1, activation=act, **kw)
                traj_k = chaotic_ann.chaotic_ann_traj(
                    *w1, x1, n_steps=steps1, activation=act, **kw)
                relu_k, _ = chaotic_ann.chaotic_ann_bits(
                    *w1, x1, off1, n_steps=steps1, **kw)
                traj_p = ref.chaotic_ann_ref(*w1, x1, steps1, act, **kw)
                e["chaotic_ann_mxu_bits"] = max(
                    max_abs_err(torch, words_k, ops.pack_words(traj_p, off1)),
                    max_abs_err(torch, state_k, traj_p[-1]))
                e["chaotic_ann_mxu_traj"] = max_abs_err(torch, traj_k,
                                                        traj_p)
                differs["K1"] = max_abs_err(torch, words_k, relu_k) > 0
                del traj_k, traj_p
                x0 = torch.as_tensor(x0_np, device=device).to(dtype)
                gkw = dict(n_steps=steps, s_block=MXU_GANG_S_BLOCK,
                           t_block=MXU_GANG_T_BLOCK, unroll=MXU_GANG_UNROLL,
                           **kw)
                for layout in ("padded", "ragged"):
                    row_map = LATTICE_K3_ROW_MAP if layout == "ragged" \
                        else None
                    rows = (chaotic_ann.gang_effective_rows(
                        row_map, steps, MXU_GANG_T_BLOCK, MXU_GANG_UNROLL)
                        if row_map is not None
                        else np.full(MXU_GANG_BLOCKS, steps // 2, np.int32))
                    lane_rows = torch.as_tensor(np.repeat(
                        rows, MXU_GANG_S_BLOCK).astype(np.int64),
                        device=device)
                    words_k, state_k = chaotic_ann.chaotic_ann_gang_bits(
                        *w, x0, core_map, off, row_map, activation=act, **gkw)
                    relu_k, _ = chaotic_ann.chaotic_ann_gang_bits(
                        *w, x0, core_map, off, row_map, **gkw)
                    words_p, state_p = ref.chaotic_ann_gang_bits_ref(
                        *w, x0, core_map, steps, off, rows, act, **kw)
                    e[f"chaotic_ann_mxu_gang_bits {layout}"] = max(
                        masked_err(torch, words_k, words_p, lane_rows),
                        max_abs_err(torch, state_k, state_p))
                    differs[f"K3 {layout}"] = masked_err(
                        torch, words_k, relu_k, lane_rows) > 0
                torch.cuda.synchronize()
                print(f"check mxu {act} {shape} {tag} (K1/K2 S={lanes1} "
                      f"steps={steps1}; K3 C={n_cores}, {MXU_GANG_BLOCKS} "
                      f"blocks x {MXU_GANG_S_BLOCK} lanes, steps={steps}): "
                      + ", ".join(f"{k} max_abs_err={v}" for k, v in e.items())
                      + f"; words differ from relu's: {differs}")
                for name, err in e.items():
                    check(err == 0.0, f"{act} {name} != plain ({shape}, "
                                      f"{tag})")
                    key = (name.split()[0], act, tag)
                    errs[key] = max(errs.get(key, 0.0), err)
                check(all(differs.values()),
                      f"{act} mxu words equal relu's ({shape}, {tag}, "
                      f"{differs}): the check cannot see a silent relu")
    print(f"tanh/sigmoid mxu kernel checks: {time.perf_counter() - t0:.1f} s")


def mxu_act_paths(torch, device, nets):
    """Phase 13's paths for one activation each: the no-config streams
    (chen@ring32 in f32, ``ChaoticStream.from_trained``, and bf16,
    ``ChaoticPRNG``; chen@ring8 in bf16), each config held to the JAX
    package's mxu choice, 2**20 words through mxu K1, the first
    MXU_STREAM_CHECK_WORDS bitwise against ``backend="ref"``, the NIST
    subset printed; each lattice iterated through mxu K2 and held against
    ``backend="ref"``; the generated chen_ring8 / chen_grid8 cores on
    ``select(24, 64, "min_latency", n_nodes=8)`` (held to the JAX one):
    each testbench on the card in its own process, each core's
    ``generate`` (mxu K2) and ``generate_bits`` (mxu K1) bitwise against
    ``backend="ref"``.  Returns {(kernel, activation, dtype tag):
    launches}."""
    import importlib
    import tempfile
    from repro_torch.core.ann import params_from_numpy
    from repro_torch.core.codegen import generate_core
    from repro_torch.core.dse import Candidate, select
    from repro_torch.kernels import ops
    from repro_torch.prng.stream import ChaoticPRNG, ChaoticStream

    launches, path_out = {}, {}

    def count(key, n):
        launches[key] = launches.get(key, 0) + n

    cand = select(24, 64, "min_latency", n_nodes=8)
    print(f"mxu cores: select(24, 64, 'min_latency', n_nodes=8) = {cand}")
    check(cand == Candidate(**MXU_SELECT),
          f"select(24, 64, 'min_latency', n_nodes=8): {cand} is not the JAX "
          f"package's")
    tmp = tempfile.TemporaryDirectory(prefix="mxu_cores_")
    sys.path.insert(0, tmp.name)
    try:
        pkgs = []
        for act in PAPER_ACTIVATIONS:
            for system in LAT_CORES:
                params, scale, offset = expand_net(nets[("chen", act)],
                                                   system)
                pkgs.append(generate_core(
                    f"{system.replace('@', '_')}_{act}_ml", tmp.name,
                    params=params, candidate=cand, system=system,
                    activation=act, scale=scale, offset=offset))
        t0 = time.perf_counter()
        run_testbenches(pkgs)
        print(f"mxu cores: {len(pkgs)} testbenches "
              f"{time.perf_counter() - t0:.1f} s")
        for act in PAPER_ACTIVATIONS:
            for system, tag in MXU_STREAMS:
                dtype = torch.float32 if tag == "f32" else torch.bfloat16
                params = expand_net(nets[("chen", act)], system)[0]
                n_nodes = 32 if system.endswith("32") else 8
                what = f"mxu stream {act} {system} {tag}"
                if tag == "f32":
                    stream = ChaoticStream.from_trained(
                        params, activation=act, device=device)
                    cfg = stream._engine.config
                    plain = ChaoticStream.from_trained(
                        params, activation=act, device=device, backend="ref")

                    def draw(s, n):
                        return s.bits(n).numpy()
                else:
                    stream = ChaoticPRNG(params, activation=act, dtype=dtype,
                                         device=device)
                    cfg = stream.config
                    plain = ChaoticPRNG(params, activation=act, dtype=dtype,
                                        device=device, backend="ref")

                    def draw(s, n):
                        return s.next_words(s.init(seed=0), n)[0]
                want = Candidate(**dict(MXU_STREAM_CONFIG, n_nodes=n_nodes,
                                        i_dim=3 * n_nodes,
                                        h_dim=8 * n_nodes,
                                        dtype_bytes=4 if tag == "f32" else 2))
                print(f"{what}: no config -> {cfg}")
                check(cfg == want, f"{what}: config {cfg} is not the JAX "
                                   f"package's select_config")
                words, n = counted_path(
                    torch, lambda: draw(stream, NIST_WORDS),
                    "chaotic_ann_mxu_bits", what)
                count(("chaotic_ann_mxu_bits", act, tag),
                      n["chaotic_ann_mxu_bits"])
                t0 = time.perf_counter()
                want_w = draw(plain, MXU_STREAM_CHECK_WORDS)
                print(f"{what}: the plain path's first "
                      f"{MXU_STREAM_CHECK_WORDS} words in "
                      f"{time.perf_counter() - t0:.1f} s")
                path_out[(act, f"{system} {tag} stream words")] = (
                    words[:MXU_STREAM_CHECK_WORDS], want_w)
                p, failed = nist3(words)
                print(f"nist {what} on {words.size} words (not gated): "
                      + ", ".join(f"{k} p={v:.4g}" for k, v in p.items())
                      + f"; under alpha {NIST_ALPHA}: {failed}")
                p_dev = params_from_numpy(params, device=device)
                x_att = torch.as_tensor(np.random.default_rng(20).uniform(
                    -0.5, 0.5, (ATTRACTOR_LANES, 3 * n_nodes)).astype(
                        np.float32), device=device).to(dtype)
                steps = MXU_ATTRACTOR_STEPS[n_nodes]
                traj, n = counted_path(torch, lambda: ops.chaotic_trajectory(
                    p_dev, x_att, steps, activation=act, config=cfg),
                    "chaotic_ann_mxu_traj", f"{what} iterated")
                count(("chaotic_ann_mxu_traj", act, tag),
                      n["chaotic_ann_mxu_traj"])
                amax = float(traj.float().abs().max())
                print(f"{what}: iterated {steps} steps on {ATTRACTOR_LANES} "
                      f"lanes: max|x| {amax:.4g}")
                check(bool(torch.isfinite(traj.float()).all()) and amax < 10.0,
                      f"{what}: the expanded net leaves the attractor box")
                path_out[(act, f"{system} {tag} iterated")] = (
                    traj, ops.chaotic_trajectory(p_dev, x_att, steps,
                                                 activation=act, config=cfg,
                                                 backend="ref"))
            for system in LAT_CORES:
                name = f"{system.replace('@', '_')}_{act}_ml"
                core = importlib.import_module(name)
                x0 = np.random.default_rng(21).uniform(
                    -0.5, 0.5, (core.S_BLOCK, 24)).astype(np.float32)
                got, n = counted_path(
                    torch, lambda: core.generate(x0, MXU_CORE_STEPS,
                                                 device=device),
                    "chaotic_ann_mxu_traj", f"core {name} generate")
                count(("chaotic_ann_mxu_traj", act, "bf16"),
                      n["chaotic_ann_mxu_traj"])
                path_out[(act, f"{name} generate")] = (got, core.generate(
                    x0, MXU_CORE_STEPS, backend="ref", device=device))
                got, n = counted_path(
                    torch, lambda: core.generate_bits(
                        x0, 2 * MXU_CORE_STEPS, device=device),
                    "chaotic_ann_mxu_bits", f"core {name} generate_bits")
                count(("chaotic_ann_mxu_bits", act, "bf16"),
                      n["chaotic_ann_mxu_bits"])
                path_out[(act, f"{name} generate_bits")] = (
                    got, core.generate_bits(x0, 2 * MXU_CORE_STEPS,
                                            backend="ref", device=device))
                sys.modules.pop(name, None)
        for (act, what), (got, want) in path_out.items():
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            e = max(max_abs_err(torch, torch.as_tensor(g), torch.as_tensor(w))
                    for g, w in zip(got, want))
            print(f"check mxu {act} path: {what} {tuple(np.shape(got[0]))} "
                  f"against the plain path: max_abs_err={e}")
            check(e == 0.0, f"mxu {act} path: {what} != plain")
    finally:
        sys.path.remove(tmp.name)
        tmp.cleanup()
    return launches


def phase_mxu_act_farm(torch, device, tag, card, nets, errs):
    """Phase 13's farm for one dtype: the four ring32 registry cores
    (relu) beside ``<system>@ring32_<activation>``, the tanh and sigmoid
    nets of phases 10 and 11 expanded to chen@ring32's descriptor, all
    added with NO config (the mxu unit), 128 clients x 128 lanes a core,
    MXU_WORDS a client; three mxu K3 groups, one an activation.  Three
    flushes (F1 uniform: one padded mxu K3 an activation; F2 the chen
    cores hot, the rest at MXU_COLD_WORDS; F3 one more client on each
    lorenz core: one padded mxu K3 an activation), each with the launch
    counters zeroed just before it and read just after, held against a
    gang=False farm (each core its own mxu K1); every gang launch against
    the plain gang scan on each core's first and last lane block, its
    first MXU_REPLAY_ROWS word rows, bitwise.  Returns ({(kernel,
    activation): launches}, {(kernel, activation, flush): times}, walls)."""
    from repro_torch.prng.stream import default_params
    from repro_torch.serve.farm import OscillatorFarm, _compat_key
    dtype = torch.float32 if tag == "f32" else torch.bfloat16
    k3, k1 = "chaotic_ann_mxu_gang_bits", "chaotic_ann_mxu_bits"
    what = f"mxu activation farm {tag}"
    expanded = {(s, a): expand_net(nets[(s, a)], f"{s}@ring32")[0]
                for s in GEN_SYSTEMS for a in PAPER_ACTIVATIONS}

    def make(gang=True):
        farm = OscillatorFarm(gang=gang, profile=True, device=device)
        for system in LATTICE_FARM:
            farm.add_core(system, default_params(system=system), dtype=dtype)
        for (s, a), params in sorted(expanded.items()):
            farm.add_core(f"{s}@ring32_{a}", params, dtype=dtype,
                          activation=a)
        return farm

    farm, solo = make(), make(gang=False)
    cores = farm.cores
    groups = {}
    for c in cores:
        groups.setdefault(_compat_key(farm.services[c]), []).append(c)
    by_act = {farm.services[g[0]].activation: sorted(g)
              for g in groups.values()}
    s_block = farm.services[cores[0]].config.s_block
    print(f"{what}: {len(cores)} cores; gang groups {by_act}; config "
          f"{farm.services[cores[0]].config}; each mxu K3 group at s_block "
          f"{s_block}, {mirrored_share(32, s_block):.1%} of the two-lane "
          f"kernel's lane halves mirrored")
    check(sorted(by_act) == ["relu", "sigmoid", "tanh"]
          and all(len(g) == len(GEN_SYSTEMS) for g in by_act.values())
          and all(farm.services[c].config.compute_unit == "mxu"
                  for c in cores),
          f"{what}: expected three mxu groups of {len(GEN_SYSTEMS)}, one an "
          f"activation")
    clients = [f"c{i:03d}" for i in range(FARM_CLIENTS)]
    t_register = register_all(torch, (farm, solo), clients, 9000)
    hot = {c: MXU_WORDS if c.startswith(GEN_HOT) else MXU_COLD_WORDS
           for c in cores}
    flushes = (("F1", {c: MXU_WORDS for c in cores}), ("F2", hot),
               ("F3", {c: MXU_WORDS for c in cores}))
    path, times, walls = {}, {}, {}
    one_each = ["relu", "sigmoid", "tanh"]
    for label, words in flushes:
        if label == "F3":                  # unequal pools: one more client
            for f in (farm, solo):
                for c in cores:
                    if c.startswith(GEN_F3):
                        f.register(c, f"c{FARM_CLIENTS}", seed=99)
        request_all((farm, solo), words)
        with GangRecorder(torch) as rec:
            _, got, decisions, modes, n_launched, walls[label] = \
                counted_flush(torch, farm, solo, f"{what} {label}", card)
        acts = sorted(r["activation"] for r in rec.calls)
        for r in rec.calls:
            key = (r["kernel"], r["activation"])
            path[key] = path.get(key, 0) + r["launches"]
        print(f"{what} {label}: gang launches by activation {acts}")
        check(all(r["launches"] == 1 and r["kernel"] == k3
                  for r in rec.calls) and got[k3] == len(rec.calls),
              f"{what} {label}: each gang call must count one mxu K3 "
              f"launch ({got}, {len(rec.calls)} calls)")
        check(all(v == 0 for k, v in got.items() if k not in (k3, k1))
              and modes == ["concat"],
              f"{what} {label}: K4 or a vpu kernel launched, or a stacked "
              f"plan ({got}, {modes})")
        if label == "F2":
            check("padded" not in decisions and got[k3] + got[k1] > 0,
                  f"{what} F2: expected ragged or split, got {decisions} "
                  f"{got}")
        else:
            check(decisions == {"padded": 3} and acts == one_each
                  and got[k1] == 0 and n_launched == 3,
                  f"{what} {label}: expected one padded mxu K3 launch an "
                  f"activation and no mxu K1, got {decisions} {got}")
        replay_calls(torch, rec, tag, f"{what} {label}", label, card, errs,
                     times, max_rows=MXU_REPLAY_ROWS)
        del rec
    for act in one_each:
        check(path.get((k3, act), 0) > 0,
              f"{k3} {act} not launched on the {what}")
    print(f"{what}: {len(cores)} cores x {FARM_CLIENTS} clients x "
          f"{LANES_PER_CLIENT} lanes; register {t_register:.3f} s per farm; "
          f"every flush bitwise equal to the gang=False farm; walls ms "
          + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in walls.items()))
    return path, times, walls


def mxu_act_times(torch, device, card, nets, errs):
    """tanh/sigmoid mxu K1 and K2 at chen@ring32, MXU_TIME_LANES x
    MXU_TIME_STEPS (the mxu path's shape), each beside relu's on the same
    weights and inputs, CUDA events; the kernels held bitwise against one
    plain run on the first MXU_TIME_PLAIN_LANES lanes (lanes are
    independent), timed; the bounds.  Returns {(act, tag): times}."""
    from repro_torch.core.ann import lattice_meta_tuple
    from repro_torch.kernels import chaotic_ann, ops, ref
    keys = ("w1", "b1", "w2", "b2")
    n, steps, n_plain = MXU_TIME_LANES, MXU_TIME_STEPS, MXU_TIME_PLAIN_LANES
    rng = np.random.default_rng(22)
    off = torch.as_tensor(rng.integers(0, 1 << 32, n, dtype=np.int64),
                          device=device)
    out = {}
    for act in PAPER_ACTIVATIONS:
        params = expand_net(nets[("chen", act)], LATTICE)[0]
        w = [torch.as_tensor(params[k], device=device) for k in keys]
        kw = dict(n_steps=steps, compute_unit="mxu",
                  lattice=lattice_meta_tuple(params["lattice_meta"]),
                  coupling=torch.as_tensor(params["coupling"], device=device))
        i_dim, h_dim = params["w1"].shape
        x_np = rng.uniform(-0.9, 0.9, (n, i_dim)).astype(np.float32)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = torch.as_tensor(x_np, device=device).to(dtype)
            t = {}
            pkw = {k: v for k, v in kw.items() if k != "n_steps"}
            traj_p, t["traj_plain_ms"] = timed_once(
                torch, lambda: ref.chaotic_ann_ref(*w, x[:n_plain], steps,
                                                   act, **pkw))
            words_p, pack_ms = timed_once(
                torch, lambda: ops.pack_words(traj_p, off[:n_plain]))
            t["bits_plain_ms"] = t["traj_plain_ms"] + pack_ms
            words_k, state_k = chaotic_ann.chaotic_ann_bits(
                *w, x, off, activation=act, **kw)
            traj_k = chaotic_ann.chaotic_ann_traj(*w, x, activation=act, **kw)
            e_bits = max(max_abs_err(torch, words_k.view(torch.int32)
                                     [:, :n_plain].view(torch.uint32),
                                     words_p),
                         max_abs_err(torch, state_k[:n_plain], traj_p[-1]))
            e_traj = max_abs_err(torch, traj_k[:, :n_plain], traj_p)
            del traj_p, words_p, words_k, traj_k
            print(f"check mxu {act} {LATTICE} {tag} S={n} steps={steps} on "
                  f"the first {n_plain} lanes: chaotic_ann_mxu_bits "
                  f"max_abs_err={e_bits} chaotic_ann_mxu_traj "
                  f"max_abs_err={e_traj}")
            check(e_bits == 0.0 and e_traj == 0.0,
                  f"{act} mxu K1/K2 != plain at {LATTICE} ({tag})")
            for name, e in (("chaotic_ann_mxu_bits", e_bits),
                            ("chaotic_ann_mxu_traj", e_traj)):
                errs[(name, act, tag)] = max(errs.get((name, act, tag), 0.0),
                                             e)
            t["bits_ms"] = cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_bits(
                *w, x, off, activation=act, **kw), reps=5, warmup=2)
            t["relu_bits_ms"] = cuda_ms(
                torch, lambda: chaotic_ann.chaotic_ann_bits(*w, x, off, **kw),
                reps=5, warmup=2)
            t["traj_ms"] = cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_traj(
                *w, x, activation=act, **kw), reps=3, warmup=1)
            t["relu_traj_ms"] = cuda_ms(
                torch, lambda: chaotic_ann.chaotic_ann_traj(*w, x, **kw),
                reps=3, warmup=1)
            item = x.element_size()
            # the chains (f32 FMAs, both dtypes) at the mxu rate, the adds
            # at the state dtype's rate, the formulas (f32 in both dtypes)
            # at the f32 rate
            mxu_step = mxu_step_flops(i_dim, h_dim, kw["lattice"], act)
            ops_step = sum(mxu_step)
            weight_bytes = (2 * i_dim * h_dim + h_dim + i_dim
                            + i_dim * i_dim) * item
            n_out = steps // 2 * n
            t["bits_bound"] = mxu_bound(
                n_out * 2, mxu_step,
                2 * n * i_dim * item + n * 4 + weight_bytes + n_out * 4, tag)
            t["traj_bound"] = mxu_bound(
                steps * n, mxu_step,
                n * i_dim * item + weight_bytes + steps * n * i_dim * item,
                tag)
            t["ops_step"] = ops_step
            out[(act, tag)] = t
            print(f"device times mxu {act} {LATTICE} {tag} (S={n}, "
                  f"n_steps={steps}, {ops_step} ops a step): "
                  f"chaotic_ann_mxu_bits {t['bits_ms']:.4f} ms (relu's "
                  f"{t['relu_bits_ms']:.4f} ms in this call; bound "
                  f"{t['bits_bound'][0]:.4f} ms by {t['bits_bound'][1]}); "
                  f"chaotic_ann_mxu_traj {t['traj_ms']:.4f} ms (relu's "
                  f"{t['relu_traj_ms']:.4f} ms; bound "
                  f"{t['traj_bound'][0]:.4f} ms by {t['traj_bound'][1]}); "
                  f"plain on {n_plain} lanes {t['bits_plain_ms']:.1f} / "
                  f"{t['traj_plain_ms']:.1f} ms; card {card}")
    return out


def phase_mxu_activations(torch, device, card, nets, errs):
    """Phase 13: the tanh/sigmoid mxu K1-K3 checks, the no-config streams,
    their iterated lattices and the min-latency generated cores, the farm
    of no-config ring32 cores per dtype, and the mxu K1/K2 times.  Returns
    the ``kernels`` rows of tanh and sigmoid mxu K1-K3."""
    t0 = time.perf_counter()
    check_mxu_act_kernels(torch, device, nets, errs)
    t1 = time.perf_counter()
    launches = mxu_act_paths(torch, device, nets)
    t2 = time.perf_counter()
    rows = []
    form = (lambda act: f"mxu unit, {act} (_activation "
            f"src/repro/kernels/chaotic_ann.py:44-45 in the dot form :154-161,"
            f" with K5's coupling dot :148-152)")
    for tag in ("f32", "bf16"):
        path, times, walls = phase_mxu_act_farm(torch, device, tag, card,
                                                nets, errs)
        name = "chaotic_ann_mxu_gang_bits"
        for act in PAPER_ACTIVATIONS:
            t3, t1_ = times[(name, act, "F3")], times[(name, act, "F1")]
            rows.append({
                "name": f"{name}/{act}/{tag}", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/chaotic_ann.cu",
                "replaces": REPLACES[name], "path": "mxu-activation-farm",
                "launches": path[(name, act)],
                "max_abs_err": errs[(name, act, tag)],
                "ms": t3["ms"], "plain_ms": t3["plain_ms"],
                "plain_lanes": t3["plain_lanes"],
                "plain_rows": t3["plain_rows"],
                "bound_ms": t3["bound"][0], "bound_by": t3["bound"][1],
                "library_ms": None, "shape": "F3 padded concat",
                "ops_step": t3["ops_step"],
                "relu_ms": times[(name, "relu", "F3")]["ms"],
                "ms_f1": t1_["ms"], "bound_ms_f1": t1_["bound"][0],
                "relu_ms_f1": times[(name, "relu", "F1")]["ms"],
                "flush_wall_ms": {k: v * 1e3 for k, v in walls.items()},
                "kernel": MXU_K3_KERNELS[tag],
                "form": form(act),
            })
    t3 = time.perf_counter()
    times = mxu_act_times(torch, device, card, nets, errs)
    for (name, act, tag), n in sorted(launches.items()):
        key = "bits" if name == "chaotic_ann_mxu_bits" else "traj"
        t = times[(act, tag)]
        rows.append({
            "name": f"{name}/{act}/{tag}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chaotic_ann.cu",
            "replaces": REPLACES[f"chaotic_ann_{key}"],
            "path": "mxu-stream" if key == "bits" else "mxu-iterated",
            "launches": n, "max_abs_err": errs[(name, act, tag)],
            "ms": t[f"{key}_ms"], "plain_ms": t[f"{key}_plain_ms"],
            "plain_lanes": MXU_TIME_PLAIN_LANES,
            "bound_ms": t[f"{key}_bound"][0],
            "bound_by": t[f"{key}_bound"][1], "library_ms": None,
            "shape": f"{LATTICE}, {MXU_TIME_LANES} lanes x "
                     f"{MXU_TIME_STEPS} steps",
            "ops_step": t["ops_step"], "relu_ms": t[f"relu_{key}_ms"],
            "form": form(act),
        })
        rows[-1]["kernel"] = (MXU_K1_KERNELS[tag] if key == "bits"
                              else K2_X2_KERNELS[("mxu", tag)])
    print(f"mxu activations: kernel checks {t1 - t0:.1f} s, paths "
          f"{t2 - t1:.1f} s, farms {t3 - t2:.1f} s, times "
          f"{time.perf_counter() - t3:.1f} s")
    return rows


def nist3(words: np.ndarray):
    """p-values of the online-gate subset, and the tests under alpha."""
    from repro_torch.prng.nist import _to_bits, block_frequency, monobit, runs
    bits = _to_bits(words)
    p = {"monobit": monobit(bits), "runs": runs(bits),
         "block_frequency": block_frequency(bits)}
    return p, [k for k, v in p.items() if v < NIST_ALPHA]


def phase_nist(torch, device, served) -> None:
    from repro_torch.prng.quality import nist_gate

    for tag, words in served.items():
        p, failed = nist3(words)
        print(f"nist {tag} on {words.size} served words: "
              + ", ".join(f"{k} p={v:.4g}" for k, v in p.items())
              + ("" if tag == "f32" else
                 f"; failed {failed}, not gated (bf16 lanes coalesce)"))
        if tag == "f32":
            check(not failed, f"f32 served words fail NIST {failed}")
    # the offline gate (repro_torch.prng.quality.nist_gate), bf16 chen
    res = nist_gate("chen", "bfloat16", device=device)
    print(f"nist gate bf16 chen ({res['n_words']} words, {GATE_STREAMS} "
          f"lanes, 7 tests): " + ", ".join(
              f"{k} p={v:.4g}" for k, v in res["p_values"].items()))
    check(not res["quarantined"],
          f"bf16 chen quarantined by the NIST gate: {res['failed_tests']} "
          f"(hard {res['hard_failed_tests']})")


def phase_sweep(torch, device, card) -> dict:
    """Part (a) of the serving tier: ``sweep_registry`` of the five
    systems in f32 and bf16 at the gate's recipe on the card, each pair's
    words held bitwise to the plain version (``backend="ref"``) on the
    first GATE_CUT_ROWS rows of the 256 lanes; no f32 pair may be
    quarantined, the bf16 verdicts are printed.  Returns the K1 launches
    of each dtype's sweep."""
    from repro_torch.kernels import chaotic_ann
    from repro_torch.prng.quality import quarantined_systems, sweep_registry
    from repro_torch.prng.stream import ChaoticPRNG, default_params

    launches, sweep = {}, {}
    t0 = time.perf_counter()
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        zero_launches(chaotic_ann)
        sweep.update(sweep_registry(dtypes=(dtype,),
                                    n_streams=GATE_STREAMS, device=device))
        got = read_launches(chaotic_ann)
        check(got["chaotic_ann_bits"] > 0 and sum(got.values())
              == got["chaotic_ann_bits"],
              f"sweep {tag}: expected chaotic_ann_bits launches alone, got "
              f"{got}")
        launches[("chaotic_ann_bits", tag)] = got["chaotic_ann_bits"]
    t_sweep = time.perf_counter() - t0
    for key, res in sweep.items():
        print(f"sweep {key} ({res['n_words']} words, {GATE_STREAMS} lanes): "
              + ", ".join(f"{k} p={v:.4g}" for k, v in
                          res["p_values"].items())
              + f"; failed {res['failed_tests']}, hard "
                f"{res['hard_failed_tests']}, quarantined "
                f"{res['quarantined']}")
    quarantined = quarantined_systems(sweep)
    print(f"sweep quarantined_systems: {quarantined}; {t_sweep:.1f} s; "
          f"card {card}")
    check(not [s for s, d in quarantined.items() if "float32" in d],
          f"an f32 registry pair is quarantined: {quarantined}")
    cut = GATE_CUT_ROWS * GATE_STREAMS
    for key, res in sweep.items():
        dtype = {"float32": torch.float32,
                 "bfloat16": torch.bfloat16}[res["dtype"]]
        words = [eng.next_words(eng.init(seed=0), cut)[0] for eng in (
            ChaoticPRNG(default_params(system=res["system"]),
                        n_streams=GATE_STREAMS, dtype=dtype, backend=b,
                        device=device) for b in ("auto", "ref"))]
        check(np.array_equal(*words),
              f"sweep {key}: kernel words differ from the plain version's")
    print(f"sweep: every pair's first {cut} words bitwise the plain "
          f"version's")
    return launches


def phase_draw_words(torch, device, card) -> dict:
    """The legacy one-shot ``draw_words`` (K2 + the packing stage) on
    chen, f32: bitwise its plain version; returns its K2 launches."""
    from repro_torch.kernels import chaotic_ann
    from repro_torch.prng.stream import default_params, draw_words

    w = default_params(system="chen")
    n_words, lanes, burn = DRAW_WORDS
    args = (w["w1"], w["b1"], w["w2"], w["b2"], 0xC0FFEE, n_words, lanes,
            burn, "relu")
    zero_launches(chaotic_ann)
    got = draw_words(*args, "auto", device=device)
    torch.cuda.synchronize()
    n = read_launches(chaotic_ann)
    check(n["chaotic_ann_traj"] == 1 and sum(n.values()) == 1,
          f"draw_words: expected one chaotic_ann_traj launch, got {n}")
    want = draw_words(*args, "ref", device=device)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32))
          and got.shape == (n_words,),
          "draw_words: kernel words differ from the plain version's")
    print(f"draw_words chen f32: {n_words} words from {lanes} lanes, "
          f"burn-in {burn}: one chaotic_ann_traj launch, bitwise the plain "
          f"version; card {card}")
    return {("chaotic_ann_traj", "f32"): n["chaotic_ann_traj"]}


def serving_farm(device, faults=None):
    """The committed farm (bf16, from ``generate_farm``) with a standby of
    SERVE_POISON on its own committed weights and solution."""
    from repro_torch.serve.farm import OscillatorFarm
    farm = OscillatorFarm.from_generated(FARM_DIR, profile=True,
                                         faults=faults, device=device)
    svc = farm.services[SERVE_POISON]
    farm.add_standby(SERVE_POISON, {k: svc.params[k] for k in
                                    ("w1", "b1", "w2", "b2")},
                     config=svc.config, dtype=svc.dtype,
                     activation=svc.activation)
    return farm


def serve_round(round_, shape, cores):
    """{(core, client): words} of one round, and its sorted tenant map."""
    reqs = {}
    for core in cores:
        for i in range(SERVE_CLIENTS + (core == "lorenz"
                                        and round_ >= SERVE_EXTRA_ROUND)):
            n = SERVE_WORDS[shape]
            if shape == "S" and core == SERVE_HOT:
                n = SERVE_HOT_WORDS
            reqs[(core, f"c{i:03d}")] = n
    return reqs


def phase_frontend(torch, device, card) -> dict:
    """Part (b) of the serving tier: the committed farm under
    ``AsyncOscillatorFarm`` (offload on, a ``HealthMonitor``, an
    ``AdmissionController``, a ``FlushJournal``, a seeded ``FaultPlan``
    with transient launch failures and SERVE_POISON's samples poisoned),
    SERVE_TENANTS tenant coroutines, one ``flush_now`` a round.  Every
    served word is held bitwise to a farm with no fault plan serving the
    same requests (with the same quarantines and rotations applied after
    the same round); then ``replay_journal`` onto a fresh farm, whose
    positions and next flush must equal the served farm's.  The launch
    counters are read around the front end's own calls alone
    (``register`` and ``flush_now``), never around the reference farm's."""
    import asyncio
    import collections
    import gc
    import tempfile

    from repro_torch.kernels import chaotic_ann
    from repro_torch.serve.admission import AdmissionController
    from repro_torch.serve.async_frontend import (AsyncOscillatorFarm,
                                                  percentile)
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.health import CoreQuarantined, HealthMonitor
    from repro_torch.serve.journal import (FlushJournal, farm_positions,
                                           read_journal, replay_journal)

    t_start = time.perf_counter()
    plan = FaultPlan(poison={SERVE_POISON}, **SERVE_FAULTS)
    farm = serving_farm(device, faults=plan)
    ref = serving_farm(device)
    cores = farm.cores
    health = HealthMonitor(**SERVE_HEALTH)
    admission = AdmissionController(max_queued_rows=1 << 20)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_journal_")
    jpath = pathlib.Path(tmp.name) / "farm.journal"
    journal = FlushJournal(jpath)
    fe_walls, sync_walls, mismatches, refused = [], [], [], []
    misses = []                 # deadline-miss samples (ms) of each round
    serving = []                # cores that served words, each round
    counts = {"register": collections.Counter(),
              "flush": collections.Counter()}
    served = 0

    def counted(what, fn, *args, **kwargs):
        zero_launches(chaotic_ann)
        try:
            return fn(*args, **kwargs)
        finally:
            counts[what].update(read_launches(chaotic_ann))

    def stages():
        p = farm.profile_stats
        return {"plan+stack": p["plan"] + p["stack"], "launch": p["launch"],
                "absorb": p["absorb"]}

    async def run():
        nonlocal served
        async with AsyncOscillatorFarm(
                farm, health=health, admission=admission, journal=journal,
                stats_window=len(SERVE_ROUNDS) * (len(cores) + 1)
                * SERVE_CLIENTS) as af:
            seeds = {(core, f"c{i:03d}"): 7000 + 1000 * k + i
                     for k, core in enumerate(cores)
                     for i in range(SERVE_CLIENTS)}
            for key, seed in seeds.items():
                counted("register", af.register, *key, seed=seed)
            for key, seed in seeds.items():
                ref.register(*key, seed=seed)
            for r, shape in enumerate(SERVE_ROUNDS):
                if r == SERVE_EXTRA_ROUND:
                    key = ("lorenz", f"c{SERVE_CLIENTS:03d}")
                    counted("register", af.register, *key, seed=99)
                    ref.register(*key, seed=99)
                reqs = serve_round(r, shape, cores)
                keys = sorted(reqs)
                submitted = []

                async def tenant(t):
                    futs = {}
                    for key in keys[t::SERVE_TENANTS]:
                        try:
                            futs[key] = af.submit(
                                *key, reqs[key],
                                deadline_ms=SERVE_DEADLINE_MS)
                        except CoreQuarantined as e:
                            refused.append((r, key, e.core))
                    submitted.append(t)
                    out = {}
                    for key, f in futs.items():
                        try:
                            out[key] = await f
                        except CoreQuarantined as e:
                            refused.append((r, key, e.core))
                    return out

                t_submit = time.perf_counter()
                tasks = [asyncio.ensure_future(tenant(t))
                         for t in range(SERVE_TENANTS)]
                while len(submitted) < SERVE_TENANTS:
                    await asyncio.sleep(0)
                before, n_miss = stages(), len(af.miss_samples_ms())
                zero_launches(chaotic_ann)
                t0 = time.perf_counter()
                t_submit = t0 - t_submit
                await af.flush_now()
                fe_walls.append(time.perf_counter() - t0)
                counts["flush"].update(read_launches(chaotic_ann))
                split = {k: v - before[k] for k, v in stages().items()}
                misses.append(af.miss_samples_ms()[n_miss:])
                got = {}
                for out in await asyncio.gather(*tasks):
                    got.update(out)
                serving.append(len({core for core, _ in got}))
                for key, n in reqs.items():
                    if key in got and key[0] not in ref.quarantined:
                        ref.request(*key, n)
                t0 = time.perf_counter()
                want = ref.flush()
                torch.cuda.synchronize()
                sync_walls.append(time.perf_counter() - t0)
                for key, words in got.items():
                    served += words.size
                    if not np.array_equal(words, want[key[0]][key[1]]):
                        mismatches.append((r, key))
                # the same topology changes, after the same round
                changed = False
                for core in sorted(farm.quarantined - ref.quarantined):
                    ref.quarantine(core, reason="mirrored")
                    changed = True
                for core, n in farm.rotations.items():
                    while ref.rotations.get(core, 0) < n:
                        ref.quarantine(core, reason="mirrored")
                        ref.rotate(core)
                        changed = True
                if changed or r % SERVE_PRINT_EVERY == 0 or not got:
                    split["rest"] = fe_walls[-1] - sum(split.values())
                    print(f"serving round {r} ({shape}): {len(got)} draws "
                          f"submitted in {t_submit * 1e3:.1f} ms, "
                          f"front-end flush {fe_walls[-1] * 1e3:.1f} ms ("
                          + ", ".join(f"{k} {v * 1e3:.1f}"
                                      for k, v in split.items())
                          + f" ms), deadline miss max "
                            f"{max(misses[-1], default=0.0):.1f} ms, sync "
                            f"farm flush {sync_walls[-1] * 1e3:.1f} ms; "
                            f"quarantined "
                            f"{sorted(farm.quarantined)}, rotations "
                            f"{farm.rotations}")
                if not got:
                    break           # every core quarantined, no standby
            return af.flushes, list(af.flush_errors)

    # the host's garbage collections while serving: a pause on the loop
    # or the launch thread lands in a flush wall and its deadline misses
    pauses, gc_t0 = [], {}

    def on_gc(phase, info):
        if phase == "start":
            gc_t0["t"] = time.perf_counter()
        elif "t" in gc_t0:
            pauses.append((info["generation"],
                           time.perf_counter() - gc_t0.pop("t"),
                           len(fe_walls)))        # the round under way

    gc.callbacks.append(on_gc)
    try:
        flushes, errors = asyncio.run(run())
    finally:
        gc.callbacks.remove(on_gc)
    journal.close()
    t_serve = time.perf_counter() - t_start
    launches = counts["register"] + counts["flush"]
    events = read_journal(jpath)[0]
    reasons = [(ev[1], ev[2]) for ev in events if ev[0] == "quarantine"]
    stats = dict(health.stats)
    by_core = {}
    for r, _, core in refused:
        first, n = by_core.get(core, (r, 0))
        by_core[core] = (min(first, r), n + 1)
    print(f"serving tier: {flushes} flushes, {farm.launches} farm launches, "
          f"the front end's kernel launches: at registration (burn-ins) "
          f"{ {k: v for k, v in counts['register'].items() if v} }, in its "
          f"flushes { {k: v for k, v in counts['flush'].items() if v} }; "
          f"{served} words served; faults injected {plan.injected}; health "
          f"{stats}; admission {admission.stats()}; quarantines {reasons}; "
          f"rotations {farm.rotations}; refused draws {{core: (first round, "
          f"draws)}} {by_core}; planner decisions {farm.plan_decisions}")

    def dist(xs, scale=1e3):
        # p99 only where it is not the largest sample or next to it
        p99 = (f"p99 {percentile(xs, 0.99) * scale:.1f} ms, "
               if len(xs) >= 100 else "")
        return (f"p50 {percentile(xs, 0.5) * scale:.1f} ms, p90 "
                f"{percentile(xs, 0.9) * scale:.1f} ms, {p99}max "
                f"{max(xs) * scale:.1f} ms")

    # round 0 holds SERVE_POISON's rotation (its standby's burn-ins) and
    # the executor thread's first launch: it is reported alone
    work = [r for r in range(1, len(fe_walls)) if serving[r]]
    by_cores = {}
    for r in work:
        by_cores.setdefault(serving[r], []).append(fe_walls[r])
    p50_by_cores = {k: (len(v), round(percentile(v, 0.5) * 1e3, 1))
                    for k, v in sorted(by_cores.items(), reverse=True)}
    print(f"serving tier flush wall, round 0 alone: front-end "
          f"{fe_walls[0] * 1e3:.1f} ms, sync farm {sync_walls[0] * 1e3:.1f}"
          f" ms; over the {len(work)} later rounds that served words: "
          f"front-end {dist([fe_walls[r] for r in work])}; sync farm "
          f"{dist([sync_walls[r] for r in work])}; front-end {{cores "
          f"serving: (rounds, p50 ms)}} {p50_by_cores}; {t_serve:.1f} s; "
          f"card {card}")
    later = [m for r in work for m in misses[r]]
    print(f"serving tier deadline misses at {SERVE_DEADLINE_MS:g} ms "
          f"deadlines: round 0's {len(misses[0])} draws p50 "
          f"{percentile(misses[0], 0.5):.1f} ms, max {max(misses[0]):.1f} "
          f"ms; the later rounds' {len(later)} draws {dist(later, 1.0)}, "
          f"missed {sum(m > 0 for m in later)}; card {card}")
    gen2 = collections.Counter()
    for g, t, r in pauses:
        if g == 2:
            gen2[r] += round(t * 1e3, 1)
    print(f"serving tier host garbage collections: {len(pauses)}, "
          f"{sum(t for _, t, _ in pauses) * 1e3:.1f} ms in all; generation "
          f"2 {{round: ms}}: {dict(gen2)}")
    for core, gate in sorted(health.last_gate.items()):
        print(f"serving tier last window {core}: " + ", ".join(
            f"{k} p={v:.4g}" for k, v in gate["p_values"].items())
            + f"; failed {gate['failed_tests']}")
    check(not errors, f"serving tier: flush errors {errors}")
    check(stats["launch_failures"] == plan.injected["transient"]
          + plan.injected["persistent"],
          f"serving tier: {stats['launch_failures']} launch failures, the "
          f"plan injected {plan.injected}")
    check(plan.injected["transient"] > 0 and stats["retries"] > 0,
          f"serving tier: no transient failure was retried ({plan.injected},"
          f" {stats})")
    check(not mismatches, f"serving tier: {len(mismatches)} draws differ "
                          f"from the fault-free farm: {mismatches[:4]}")
    check(all(c == key[0] and c in farm.quarantined
              for _, key, c in refused),
          f"serving tier: draws refused on a core that is not quarantined "
          f"with no standby: {refused[:4]}")
    check(farm.rotations.get(SERVE_POISON) == 1
          and any(c == SERVE_POISON and r.startswith("online quality hard")
                  for c, r in reasons),
          f"serving tier: {SERVE_POISON} not quarantined by its poisoned "
          f"window and rotated once ({reasons}, {farm.rotations})")
    # every later quarantine (SERVE_POISON's standby included) comes from
    # a failing window of the core's own real words
    poisoned = [c for c, _ in reasons].index(SERVE_POISON)
    for i, (core, reason) in enumerate(reasons):
        check(reason.startswith("online quality")
              or (reason.startswith("circuit breaker")
                  and "injected" in reason),
              f"serving tier: {core} quarantined for {reason!r}")
        if i != poisoned:
            check(bool(health.last_gate[core]["failed_tests"]),
                  f"serving tier: {core} quarantined with no failing "
                  f"window of its own words")
    check(counts["flush"]["chaotic_ann_gang_bits"] > 0
          and counts["flush"]["chaotic_ann_gang_stacked"] > 0,
          f"serving tier: K3 and K4 not both launched by the front end's "
          f"flushes: {dict(counts['flush'])}")

    # a new process: the same farm and standby, the journal alone
    plan.disarm()
    fresh = serving_farm(device)
    summary = replay_journal(fresh, jpath)
    check(farm_positions(fresh) == farm_positions(farm)
          and fresh.quarantined == farm.quarantined
          and fresh.rotations == farm.rotations,
          f"serving tier: replay_journal did not restore the positions "
          f"({summary})")
    reqs = serve_round(len(SERVE_ROUNDS), "U", cores)
    for f in (farm, fresh):
        for key, n in reqs.items():
            if key[0] not in f.quarantined:
                f.request(*key, n)
    check(same_words(farm.flush(), fresh.flush()),
          "serving tier: the replayed farm's next flush differs")
    tmp.cleanup()
    print(f"serving tier journal: {summary}; replayed farm's next flush "
          f"bitwise the served farm's")
    return {("chaotic_ann_bits", "bf16"): launches["chaotic_ann_bits"],
            ("chaotic_ann_gang_bits", "bf16"):
                launches["chaotic_ann_gang_bits"],
            ("chaotic_ann_gang_stacked", "bf16"):
                launches["chaotic_ann_gang_stacked"]}


def phase_serving_tier(torch, device, card) -> dict:
    """The serving tier: the offline sweep, ``draw_words`` and the async
    front-end over the committed farm.  Returns {(kernel, dtype):
    launches} of the phase."""
    t0 = time.perf_counter()
    launches = phase_sweep(torch, device, card)
    launches.update(phase_draw_words(torch, device, card))
    for key, n in phase_frontend(torch, device, card).items():
        launches[key] = launches.get(key, 0) + n
    print(f"serving tier phase: {time.perf_counter() - t0:.1f} s; launches "
          f"{ {f'{k}/{t}': n for (k, t), n in sorted(launches.items())} }; "
          f"card {card}")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: every shape the reference's kernels take
# ---------------------------------------------------------------------------

# the shape libraries the phase builds up front, in one parallel build
# (kernels/build.py's keys): the paper's 3-4 and 3-16 nets on both units,
# chen@ring16, chen@grid24 (24 nodes: a lane slot of 32 threads, 8 idle)
# hyperlorenz@grid4 (the 4-16 base) and hyperlorenz@ring6 (6 nodes: slots
# of 8 threads, 2 idle, four slots a warp) on both
SHAPE_KEYS = (("scalar", (3, 4)), ("scalar", (3, 16)),
              ("mxu", (3, 4, 1, 0)), ("mxu", (3, 16, 1, 0)),
              ("lattice", (3, 8, 16, 0)), ("lattice", (3, 8, 24, 1)),
              ("lattice", (4, 16, 4, 1)), ("lattice", (4, 16, 6, 0)),
              ("mxu", (3, 8, 16, 0)), ("mxu", (3, 8, 24, 1)),
              ("mxu", (4, 16, 4, 1)), ("mxu", (4, 16, 6, 0)))
# the paper's sweep across ANN sizes (Figs. 3 and 5 at H = 4, 8, 16): chen
# 3-H-3 nets trained on the card, (label, H, activation, init seed), on
# phase 10's dataset and recipe (PAPER_SAMPLES, lr 3e-3, batch 256) for a
# third of its epochs: 60 epochs took 23-26 s a net on the H100, over half
# the phase's budget.  A relu net's testbench trajectory leaves the
# attractor box at some seeds and epochs and not at others; the seeds are
# ones whose nets stay in it at every epoch from 10 to 45 or 60
# (tools/sweep_net_seeds.py), so every testbench must pass
SHAPE_NETS = (("3-4", 4, "relu", 4), ("3-16", 16, "relu", 1),
              ("3-16-tanh", 16, "tanh", 0))
SHAPE_EPOCHS = 20
SHAPE_MODES = ("min_latency", "lowest_cost", "pareto")
# the JAX package's select(3, H, mode) (tests/test_torch_paper_flow.py
# holds the copied DSE to it): vpu bf16 at every mode, p 5 / 0 / 3
SHAPE_SELECT = {
    mode: dict(p=p, compute_unit="vpu", dtype_bytes=2, unroll=un,
               t_block=tb, n_nodes=1)
    for mode, p, un, tb in (("min_latency", 5, 8, 256),
                            ("lowest_cost", 0, 1, 32),
                            ("pareto", 3, 8, 256))}
SHAPE_CORE_STEPS = 256
SHAPE_STREAM_WORDS = 1 << 16          # a scalar net's f32 stream
SHAPE_CHECK_WORDS = 1 << 12           # its first words held to the plain path
# lattice streams: 16 clients x 1,024 lanes (16,384 lanes), 4 word rows a
# client a flush; the plain version computes two clients' rows
SHAPE_LATTICES = ("chen@ring16", "chen@grid24", "hyperlorenz@grid4",
                  "hyperlorenz@ring6")
SHAPE_CLIENTS, SHAPE_LANES, SHAPE_WORDS = 16, 1_024, 4_096
SHAPE_PLAIN_CLIENTS = 2
# the farms: 8 clients x 128 lanes a core, 16 word rows a flush
SHAPE_FARM_BASES = ("chen", "chua", "lorenz", "rossler")     # @grid24
SHAPE_FARM_CLIENTS, SHAPE_FARM_WORDS = 8, 2_048
# each (kernel, shape) row's check against its plain version: (lanes,
# steps) by (lattice, unit); K3 blocks of 128 lanes, K4 two or four cores
# of lanes / cores lanes
SHAPE_CHECK = {(False, "vpu"): (16_384 + 37, 64),
               (False, "mxu"): (4_096 + 37, 32),
               (True, "vpu"): (4_096 + 37, 16),
               (True, "mxu"): (1_024 + 37, 4)}
# ... and each kernel timed at the path's width: 65,536 lanes (K3 512
# blocks of 128, K4 two or four cores), steps by (lattice, unit)
SHAPE_TIME = {(False, "vpu"): (65_536, 256), (False, "mxu"): (65_536, 64),
              (True, "vpu"): (65_536, 64), (True, "mxu"): (65_536, 16)}
# W's cost: the lattice K1 at chen@grid24 beside chen@grid32 (the default
# library), lanes x steps
SHAPE_W_LANES, SHAPE_W_STEPS = 16_384, 64

# phase 15, the farm across devices (``distributed.sharding.DeviceMesh``):
# cuda:0 listed 1, 2 and 4 times (one card partitioned k ways, each shard
# a launch of its own on the card's stream) and every visible card when
# there are several.  The committed farm at F1-F3 in both dtypes on every
# mesh; the served chen at its full width (N_CLIENTS x LANES_PER_CLIENT)
# on the meshes of 2 and more, SHARD_SERVED_WORDS a client a flush (the
# served path's 65,536 cut: its flush is absorb-bound); the chen@ring32
# lattice farm (vpu) and the mxu farm at F1 and F3 on SHARD_SIDE_MESH
SHARD_REPEATS = (1, 2, 4)
SHARD_SERVED_WORDS, SHARD_SERVED_FLUSHES = 16_384, 2
SHARD_SIDE_MESH = "cuda:0 x2"
SHARD_FIT_MESH = "cuda:0 x4"
# the fit times F1's pools (FARM_CLIENTS x LANES_PER_CLIENT lanes, the
# four cores of the 3-8-3 gang), more reps than its default 3 against host
# jitter; the fitted model's price of F1's stacked launch (one K4 call at
# that shape, timed on the host as the fit times) must lie within
# SHARD_FIT_FACTOR of the call's time either way.  On an H100 that call
# takes 0.15-0.25 ms, most of it the host's side of the launch, which
# jitters by tens of microseconds from call to call; the default model
# prices it at 0.03-0.05 ms, under a third
SHARD_FIT_REPS, SHARD_FIT_FACTOR = 15, 3.0


def shape_label(key) -> str:
    family, dims = key
    return f"{family} " + "-".join(map(str, dims))


def phase_shape_build(card) -> float:
    """The phase's shape libraries in one parallel build (``nvcc``
    processes of every library started together), then loaded through
    ``prepare`` (which builds nothing more).  Prints each library's
    seconds from the start and its registers and spills, and the wall."""
    from repro_torch.kernels import build, chaotic_ann
    t0 = time.perf_counter()
    built = build.build_libraries(SHAPE_KEYS)
    wall = time.perf_counter() - t0
    check(not any(chaotic_ann.prepare(SHAPE_KEYS).values()),
          "prepare rebuilt a library the phase had built")
    for key in SHAPE_KEYS:
        secs, log = built.get(key, (0.0, ""))
        print(f"shape library {shape_label(key)} "
              f"({build.library_path(key=key).name}): "
              + (f"built in {secs:.1f} s; ptxas: {register_report(log)}"
                 if log else "reused"))
    print(f"shape libraries: {len(built)} built in {wall:.1f} s, one "
          f"parallel build (their seconds from the start sum to "
          f"{sum(s for s, _ in built.values()):.1f} s); card {card}")
    return wall


def shape_counted(torch, launches, key, fn, want, what):
    """``counted_path``, its launches added to ``launches[(kernel,) +
    key]``, key (shape, dtype)."""
    out, got = counted_path(torch, fn, want, what)
    for name, n in got.items():
        launches[(name,) + key] = launches.get((name,) + key, 0) + n
    return out


def same_bits(torch, got, want, what) -> None:
    """Every tensor of ``got`` bitwise its twin in ``want`` (numpy uint32
    words compared as integers)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)

    def err(g, w):
        if isinstance(g, np.ndarray):
            d = np.abs(g.astype(np.int64) - w.astype(np.int64))
            return float(d.max()) if d.size else 0.0
        return max_abs_err(torch, g, w)

    e = max(err(g, w) for g, w in zip(got, want))
    print(f"check shapes {what}: max_abs_err={e}")
    check(e == 0.0, f"shapes {what}: kernel path != plain path")


def shape_nets(torch, device, card, ds):
    """The paper's sweep: chen 3-H-3 nets trained on the card
    (SHAPE_NETS) on ``ds`` (phase 10's chen dataset, or the same one made
    here on the card).  Returns {label: (H, activation, numpy bundle, scale,
    offset, the first ATTRACTOR_LANES test inputs)}."""
    from repro_torch.core.ann import AnnConfig, extract_parameters, train
    from repro_torch.core.chaotic import make_dataset
    if ds is None:
        t0 = time.perf_counter()
        ds = make_dataset("chen", n_samples=PAPER_SAMPLES, device=device)
        print(f"shapes: chen dataset, {PAPER_SAMPLES} samples on the "
              f"card in {time.perf_counter() - t0:.1f} s")
    nets = {}
    for label, h_dim, act, seed in SHAPE_NETS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, hist = train(AnnConfig(dim=3, hidden=h_dim, activation=act),
                             ds, epochs=SHAPE_EPOCHS, batch_size=256,
                             lr=3e-3, seed=seed, device=device)
        torch.cuda.synchronize()
        m = hist["test_metrics"]
        print(f"shapes: chen 3-{h_dim}-3 {act} (seed {seed}) trained "
              f"{SHAPE_EPOCHS} epochs on the card in {time.perf_counter() - t0:.1f} s; "
              f"MSE={m['mse']:.4g} R2={m['r2']:.6f}; card {card}")
        check(np.isfinite(list(m.values())).all() and m["r2"] > 0.99,
              f"3-{h_dim}-3 {act} training: {m}")
        nets[label] = (h_dim, act, extract_parameters(params), ds.scale,
                       ds.offset, np.asarray(ds.x_test[:ATTRACTOR_LANES]))
    return nets


def shape_cores(torch, device, nets, tmp, launches):
    """``select`` in the three user modes (held to the JAX package's),
    ``generate_core`` for each net and mode, every testbench on the card,
    and per net the min-latency core's ``generate`` (K2) and
    ``generate_bits`` (K1) beside ``backend="ref"``, a no-config f32
    stream (K1) and the net iterated (K2) beside the plain path, and on
    the 3-16 relu net an mxu stream (mxu K1) and trajectory (mxu K2) in
    both dtypes.  Returns the generated packages."""
    import importlib
    from repro_torch.core.ann import params_from_numpy
    from repro_torch.core.codegen import generate_core
    from repro_torch.core.dse import Candidate, select, select_config
    from repro_torch.kernels import ops
    from repro_torch.prng.stream import ChaoticPRNG, ChaoticStream
    pkgs = {}
    for label, (h_dim, act, bundle, scale, offset, _) in nets.items():
        for mode in SHAPE_MODES:
            cand = select(3, h_dim, mode)
            check(cand == Candidate(i_dim=3, h_dim=h_dim,
                                    **SHAPE_SELECT[mode]),
                  f"select(3, {h_dim}, {mode!r}) = {cand}: not the JAX "
                  f"package's")
            name = f"chen_3{h_dim}3_{act}_{mode}"
            pkgs[(label, mode)] = generate_core(
                name, tmp, params=bundle, candidate=cand, system="chen",
                activation=act, scale=scale, offset=offset)
        print(f"shapes {label}: select(3, {h_dim}, mode) for "
              f"{SHAPE_MODES}, each the JAX package's: " + ", ".join(
                  str(select(3, h_dim, m)) for m in SHAPE_MODES))
    t0 = time.perf_counter()
    run_testbenches(list(pkgs.values()))
    print(f"shapes: {len(pkgs)} testbenches in "
          f"{time.perf_counter() - t0:.1f} s")
    for label, (h_dim, act, bundle, _, _, x_att) in nets.items():
        core = importlib.import_module(pkgs[(label, "min_latency")].name)
        x0 = np.random.default_rng(h_dim).uniform(
            -0.5, 0.5, (core.S_BLOCK, 3)).astype(np.float32)
        key = (label, "bf16")
        same_bits(torch, shape_counted(
            torch, launches, key, lambda: core.generate(
                x0, SHAPE_CORE_STEPS, device=device),
            {"chaotic_ann_traj"}, f"{label} core generate"),
            core.generate(x0, SHAPE_CORE_STEPS, backend="ref",
                          device=device), f"{label} core generate")
        same_bits(torch, shape_counted(
            torch, launches, key, lambda: core.generate_bits(
                x0, 2 * SHAPE_CORE_STEPS, device=device),
            {"chaotic_ann_bits"}, f"{label} core generate_bits"),
            core.generate_bits(x0, 2 * SHAPE_CORE_STEPS, backend="ref",
                               device=device), f"{label} core generate_bits")
        stream = ChaoticStream.from_trained(bundle, activation=act,
                                            device=device)
        words = shape_counted(
            torch, launches, (label, "f32"),
            lambda: stream.bits(SHAPE_STREAM_WORDS).numpy(),
            {"chaotic_ann_bits"}, f"{label} f32 stream")
        plain = ChaoticStream.from_trained(bundle, activation=act,
                                           device=device, backend="ref")
        same_bits(torch, words[:SHAPE_CHECK_WORDS],
                  plain.bits(SHAPE_CHECK_WORDS).numpy(),
                  f"{label} f32 stream, first {SHAPE_CHECK_WORDS} words")
        p_dev = params_from_numpy(bundle, device=device)
        x_att = torch.as_tensor(x_att, device=device)
        traj = shape_counted(
            torch, launches, (label, "f32"), lambda: ops.chaotic_trajectory(
                p_dev, x_att, ATTRACTOR_STEPS, activation=act),
            {"chaotic_ann_traj"}, f"{label} iterated")
        print(f"shapes {label}: {ATTRACTOR_STEPS} autonomous steps of "
              f"{ATTRACTOR_LANES} lanes from test inputs, max|x| "
              f"{float(traj.abs().max()):.4g} (the net's own; not gated)")
        same_bits(torch, traj, ops.chaotic_trajectory(
            p_dev, x_att, ATTRACTOR_STEPS, activation=act, backend="ref"),
            f"{label} iterated")
        if label != "3-16":
            continue
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            # t_block 16: a check-sized launch (t_block changes no value)
            cfg = dataclasses.replace(select_config(
                3, h_dim, s_total=256, dtype=dtype, unit="mxu"), t_block=16)
            eng = ChaoticPRNG(bundle, config=cfg, dtype=dtype, device=device)
            ref_eng = ChaoticPRNG(bundle, config=cfg, dtype=dtype,
                                  device=device, backend="ref")
            got = shape_counted(
                torch, launches, (label, tag),
                lambda: eng.next_words(eng.init(5), SHAPE_CHECK_WORDS)[0],
                {"chaotic_ann_mxu_bits"}, f"{label} mxu {tag} stream")
            want = ref_eng.next_words(ref_eng.init(5), SHAPE_CHECK_WORDS)[0]
            same_bits(torch, got, want, f"{label} mxu {tag} stream ({cfg})")
            xm = torch.as_tensor(x0, device=device).to(dtype)
            same_bits(torch, shape_counted(
                torch, launches, (label, tag), lambda: ops.chaotic_trajectory(
                    p_dev, xm, 64, compute_unit="mxu"),
                {"chaotic_ann_mxu_traj"}, f"{label} mxu {tag} iterated"),
                ops.chaotic_trajectory(p_dev, xm, 64, compute_unit="mxu",
                                       backend="ref"),
                f"{label} mxu {tag} iterated")
        sys.modules.pop(pkgs[(label, "min_latency")].name, None)
    return pkgs


def shape_farm_flushes(torch, launches, key, farms, grow, words, want):
    """F1 uniform and F3 one more client on each core of ``grow``, the
    counters zeroed around each flush and its launches attributed to
    ``key``; each flush's words held bitwise to the gang=False farm.
    ``farms`` is (gang, solo); ``want`` {flush: kernels it must launch}."""
    farm, solo = farms
    register_all(torch, farms, [f"c{i}" for i in range(SHAPE_FARM_CLIENTS)],
                 31_000)
    for flush in ("F1", "F3"):
        if flush == "F3":
            for f in farms:
                for k, core in enumerate(f.cores):
                    if core in grow:
                        f.register(core, "extra", seed=32_000 + k)
        request_all(farms, dict.fromkeys(farm.cores, words))
        out = shape_counted(torch, launches, key, farm.flush, want[flush],
                            f"{key[0]} {key[1]} farm {flush}")
        n = sum(w.size for c in out.values() for w in c.values())
        check(same_words(out, solo.flush()),
              f"{key[0]} {key[1]} farm {flush}: gang words differ from "
              f"gang=False")
        print(f"shapes {key[0]} {key[1]} farm {flush}: {n} words, bitwise "
              f"gang=False; decisions {farm.plan_decisions}")


def shape_scalar_farms(torch, device, nets, pkgs, launches):
    """Per net and dtype, a farm of its three generated cores (bf16:
    ``from_generated``; f32: the same solutions at dtype_bytes=4): the
    min-latency and Pareto cores gang once their stream block is clamped
    to a client's lanes (K4 at F1, K3 at F3), the lowest-cost core runs
    alone (K1); the 3-16 relu net also as two cores on an mxu config
    (mxu K3)."""
    from repro_torch.core.dse import Candidate, select_config
    from repro_torch.serve.farm import OscillatorFarm
    for label, (h_dim, act, bundle, _, _, _) in nets.items():
        names = [pkgs[(label, m)].name for m in SHAPE_MODES]
        tmp = pkgs[(label, SHAPE_MODES[0])].parent
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            def make(gang):
                if tag == "bf16":
                    farm = OscillatorFarm.from_generated(
                        tmp, cores=names, gang=gang, device=device)
                else:
                    farm = OscillatorFarm(gang=gang, device=device)
                    for name in names:
                        sol = json.loads((tmp / name / "solution.json")
                                         .read_text())
                        cand = dataclasses.replace(
                            Candidate(**sol["candidate"]), dtype_bytes=4,
                            p=0)
                        farm.add_core(name, bundle, config=cand,
                                      dtype=dtype, activation=act)
                if label == "3-16":
                    cfg = select_config(3, h_dim, s_total=128, dtype=dtype,
                                        unit="mxu")
                    for name in ("mxu_a", "mxu_b"):
                        farm.add_core(name, bundle, config=cfg, dtype=dtype,
                                      activation=act)
                return farm

            want = {"chaotic_ann_gang_stacked", "chaotic_ann_bits"}
            want3 = {"chaotic_ann_gang_bits", "chaotic_ann_bits"}
            if label == "3-16":
                want = want | {"chaotic_ann_mxu_gang_bits"}
                want3 = want3 | {"chaotic_ann_mxu_gang_bits"}
            shape_farm_flushes(torch, launches, (label, tag),
                               (make(True), make(False)),
                               {names[2], "mxu_b"}, SHAPE_FARM_WORDS,
                               {"F1": want, "F3": want3})


def shape_lattice_streams(torch, device, launches, systems=SHAPE_LATTICES,
                          iterated=(1_024 + 37, 8)):
    """Per lattice of ``systems`` and dtype: ``PRNGService`` at 16,384
    lanes on an explicit vpu config (lattice K1 served, lattice K2
    unfused on the same flush) and with no config (the JAX package's
    choice: mxu K1, the vpu at f32 on the 4-16 base); each flush's first
    two clients bitwise one plain K1 run from the pool and offsets it
    launched from, the unfused words bitwise every client's; the lattice
    iterated on the mxu unit (mxu K2) beside the plain path, at
    ``iterated`` (lanes, steps)."""
    from repro_torch.core.ann import lattice_meta_tuple, params_from_numpy
    from repro_torch.core.dse import default_config
    from repro_torch.kernels import ops, ref
    from repro_torch.prng.stream import default_params
    from repro_torch.serve.prng_service import PRNGService
    rows = SHAPE_WORDS // SHAPE_LANES
    n_plain = SHAPE_PLAIN_CLIENTS * SHAPE_LANES
    for system in systems:
        p = default_params(system=system)
        lat = lattice_meta_tuple(p["lattice_meta"])
        i_dim, h_dim = p["w1"].shape
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            key = (system, tag)
            for cfg in (default_config(i_dim, h_dim, dtype, n_nodes=lat[0]),
                        None):
                svc = PRNGService(p, lanes_per_client=SHAPE_LANES,
                                  config=cfg, dtype=dtype, device=device)
                unit = svc.config.compute_unit
                k1 = ("chaotic_ann_mxu_bits" if unit == "mxu"
                      else "chaotic_ann_lattice_bits")
                shape_counted(torch, launches, key, lambda: [
                    svc.register(f"c{i}", seed=41_000 + i)
                    for i in range(SHAPE_CLIENTS)], {k1},
                    f"{system} {tag} {unit} register")
                for name in svc.clients:
                    svc.request(name, SHAPE_WORDS)
                pools, offs = launch_inputs(torch, device, [svc])
                t0 = time.perf_counter()
                out = shape_counted(torch, launches, key, svc.flush, {k1},
                                    f"{system} {tag} {unit} flush")
                wall = time.perf_counter() - t0
                served = np.concatenate(
                    [out[n].reshape(rows, -1) for n in svc.clients], axis=1)
                w = [svc.params[k] for k in ("w1", "b1", "w2", "b2")]
                want, _ = ref.chaotic_ann_bits_ref(
                    *w, pools[0][:n_plain], 2 * rows, offs[0][:n_plain],
                    "relu", lat, unit, svc.params.get("coupling"))
                check(np.array_equal(ops.from_uint32(want).cpu().numpy(),
                                     served[:, :n_plain].astype(np.int64)),
                      f"{system} {tag} {unit}: served words != plain")
                print(f"shapes {system} {tag} "
                      f"({'no config' if cfg is None else 'vpu config'}: "
                      f"{svc.config}): {SHAPE_CLIENTS} clients x "
                      f"{SHAPE_LANES} lanes, {SHAPE_WORDS} words a client, "
                      f"flush {wall * 1e3:.1f} ms; the first {n_plain} "
                      f"lanes bitwise the plain K1")
                if cfg is None:
                    continue
                traj = shape_counted(
                    torch, launches, key, lambda: ops.chaotic_trajectory(
                        svc.params, pools[0], 2 * rows, config=svc.config),
                    {"chaotic_ann_lattice_traj"},
                    f"{system} {tag} unfused")
                words = ops.pack_words(traj, offs[0])
                check(np.array_equal(ops.from_uint32(words).cpu().numpy(),
                                     served.astype(np.int64)),
                      f"{system} {tag}: unfused words != served")
            p_dev = params_from_numpy(p, device=device)
            x = torch.as_tensor(np.random.default_rng(17).uniform(
                -0.9, 0.9, (iterated[0], i_dim)).astype(np.float32),
                device=device).to(dtype)
            same_bits(torch, shape_counted(
                torch, launches, key, lambda: ops.chaotic_trajectory(
                    p_dev, x, iterated[1], compute_unit="mxu"),
                {"chaotic_ann_mxu_traj"}, f"{system} {tag} mxu iterated"),
                ops.chaotic_trajectory(p_dev, x, iterated[1],
                                       compute_unit="mxu", backend="ref"),
                f"{system} {tag} mxu iterated")


def shape_lattice_farm(torch, device, launches, lattice="grid24"):
    """Per dtype, a farm of chen, chua, lorenz and rossler @``lattice`` on
    a vpu config (lattice K4 at F1, K3 at F3) beside the same four with no
    config (the mxu unit: mxu K3 at both), 8 clients x 128 lanes a core;
    each flush bitwise a gang=False farm.  Prints the mxu group's s_block
    and its share of mirrored lane halves."""
    from repro_torch.core.ann import lattice_meta_tuple
    from repro_torch.core.dse import default_config
    from repro_torch.kernels import chaotic_ann
    from repro_torch.prng.stream import default_params
    from repro_torch.serve.farm import OscillatorFarm
    params = {b: default_params(system=f"{b}@{lattice}")
              for b in SHAPE_FARM_BASES}
    n_nodes = lattice_meta_tuple(params["chen"]["lattice_meta"])[0]
    i_dim, h_dim = params["chen"]["w1"].shape
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        cfg = default_config(i_dim, h_dim, dtype, n_nodes=n_nodes)

        def make(gang):
            farm = OscillatorFarm(gang=gang, device=device)
            for b, p in params.items():
                farm.add_core(f"{b}@{lattice}", p, config=cfg, dtype=dtype)
                farm.add_core(f"{b}@{lattice}_mxu", p, dtype=dtype)
            return farm

        farms = (make(True), make(False))
        mxu_cfg = farms[0].services[f"chen@{lattice}_mxu"].config
        check(mxu_cfg.compute_unit == "mxu",
              f"no-config {lattice} cores are not on the mxu unit")
        print(f"shapes chen@{lattice} {tag} farm: the mxu K3 group at "
              f"s_block {mxu_cfg.s_block}, "
              f"{mirrored_share(n_nodes, mxu_cfg.s_block):.1%} of the "
              f"two-lane kernel's lane halves mirrored (slot of "
              f"{chaotic_ann.slot_width(n_nodes)} threads)")
        shape_farm_flushes(
            torch, launches, (f"chen@{lattice}", tag), farms,
            {f"lorenz@{lattice}", f"lorenz@{lattice}_mxu"}, SHAPE_FARM_WORDS,
            {"F1": {"chaotic_ann_lattice_gang_stacked",
                    "chaotic_ann_mxu_gang_bits"},
             "F3": {"chaotic_ann_lattice_gang_bits",
                    "chaotic_ann_mxu_gang_bits"}})


def shape_operands(torch, device, nets):
    """Each row shape's operands: {shape: (weights, stacked gang weights,
    activation, lattice, coupling)}: a trained net with a scaled copy as
    its gang; a lattice with the four bases @grid24 as chen@grid24's gang,
    else with a scaled copy."""
    from repro_torch.core.ann import lattice_meta_tuple
    from repro_torch.prng.stream import default_params
    keys = ("w1", "b1", "w2", "b2")
    ops_ = {}

    def on(p):
        return [torch.as_tensor(np.asarray(p[k], np.float32), device=device)
                for k in keys]

    for label, (_, act, bundle, _, _, _) in nets.items():
        w = on(bundle)
        ops_[label] = (w, [torch.stack([t, t * 0.9375]) for t in w], act,
                       None, None)
    for system in SHAPE_LATTICES:
        p = default_params(system=system)
        w = on(p)
        if system == "chen@grid24":
            gang = [torch.stack(ts) for ts in zip(*(
                on(default_params(system=f"{b}@grid24"))
                for b in SHAPE_FARM_BASES))]
        else:
            gang = [torch.stack([t, t * 0.9375]) for t in w]
        ops_[system] = (w, gang, "relu", lattice_meta_tuple(p["lattice_meta"]),
                        torch.as_tensor(p["coupling"], device=device))
    return ops_


def shape_launch(torch, device, name, tag, operands, lanes, steps, seed):
    """One (kernel, shape, dtype) launch of ``lanes`` lanes and ``steps``
    steps on seeded inputs: (kernel call, plain call, the two results'
    ``max_abs_err`` over what each lane asked for, lane-steps computed,
    bytes in and out once, a label).  K3 runs blocks of 128 lanes with
    ragged rows, K4 two or four cores with unequal rows."""
    from repro_torch.kernels import chaotic_ann, ref
    w, gang, act, lattice, cpl = operands
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[tag]
    unit = "mxu" if "mxu" in name else "vpu"
    c = cpl if unit == "mxu" else None
    i_dim, h_dim = w[0].shape
    item = 2 if tag == "bf16" else 4
    rng = np.random.default_rng(seed)

    def states(shape_):
        return torch.as_tensor(rng.uniform(-0.9, 0.9, shape_).astype(
            np.float32), device=device).to(dtype)

    def offsets(shape_):
        return torch.as_tensor(rng.integers(0, 1 << 32, shape_),
                               device=device)

    weight_bytes = (2 * i_dim * h_dim + h_dim + i_dim) * item + (
        i_dim * i_dim * item if c is not None else 0)
    kw = dict(activation=act, lattice=lattice, compute_unit=unit, coupling=c)
    half = steps // 2
    if name.endswith("_traj"):
        x = states((lanes, i_dim))
        return (lambda: chaotic_ann.chaotic_ann_traj(*w, x, n_steps=steps,
                                                     **kw),
                lambda: ref.chaotic_ann_ref(*w, x, steps, act, lattice, unit,
                                            c),
                lambda got, want: max_abs_err(torch, got, want),
                lanes * steps,
                lanes * i_dim * item * (1 + steps) + weight_bytes,
                f"{lanes} lanes x {steps} steps")
    if "gang" not in name:
        x, off = states((lanes, i_dim)), offsets(lanes)
        return (lambda: chaotic_ann.chaotic_ann_bits(*w, x, off,
                                                     n_steps=steps, **kw),
                lambda: ref.chaotic_ann_bits_ref(*w, x, steps, off, act,
                                                 lattice, unit, c),
                lambda got, want: max(max_abs_err(torch, g, p)
                                      for g, p in zip(got, want)),
                lanes * steps,
                2 * lanes * i_dim * item + lanes * 8 + weight_bytes
                + half * lanes * 4,
                f"{lanes} lanes x {steps} steps")
    n_cores = gang[0].shape[0]
    if "gang_bits" in name:
        s_block = 128
        n_blocks = max(2, lanes // s_block)
        core_map = np.arange(n_blocks) % n_cores
        row_map = np.resize([0, 3, half, 5, half, 1, half // 2, half],
                            n_blocks)
        rows = chaotic_ann.gang_effective_rows(row_map, steps, 4, 1)
        x, off = states((n_blocks * s_block, i_dim)), offsets(n_blocks
                                                              * s_block)
        lane_rows = torch.as_tensor(np.repeat(rows, s_block), device=device)
        return (lambda: chaotic_ann.chaotic_ann_gang_bits(
                    *gang, x, core_map, off, row_map, n_steps=steps,
                    s_block=s_block, t_block=4, unroll=1, **kw),
                lambda: ref.chaotic_ann_gang_bits_ref(
                    *gang, x, core_map, steps, off, rows, act, lattice, unit,
                    c),
                lambda got, want: max(
                    masked_err(torch, got[0], want[0], lane_rows),
                    max_abs_err(torch, got[1], want[1])),
                2 * s_block * int(rows.sum()),
                2 * x.numel() * item + x.shape[0] * 8
                + weight_bytes * n_cores + s_block * int(rows.sum()) * 4,
                f"{n_blocks} blocks x {s_block} lanes, rows "
                f"{rows[:8].tolist()}... of {half}")
    per_core = lanes // n_cores
    row_map = np.array([half, half // 3, half, 1][:n_cores])
    x, off = states((n_cores, per_core, i_dim)), offsets((n_cores, per_core))
    lane_rows = torch.as_tensor(row_map, device=device).reshape(-1, 1)
    return (lambda: chaotic_ann.chaotic_ann_gang_stacked(
                *gang, x, off, row_map, n_steps=steps, activation=act,
                lattice=lattice),
            lambda: ref.chaotic_ann_gang_stacked_ref(
                *gang, x, steps, off, row_map, act, lattice),
            lambda got, want: max(masked_err(torch, got[0], want[0],
                                             lane_rows),
                                  max_abs_err(torch, got[1], want[1])),
            2 * per_core * int(row_map.sum()),
            2 * x.numel() * item + n_cores * per_core * 8
            + weight_bytes * n_cores + per_core * int(row_map.sum()) * 4,
            f"{n_cores} cores x {per_core} lanes, rows {row_map.tolist()} of "
            f"{half}")


def shape_row(torch, device, name, shape, tag, operands, launches, card,
              errs, cuts=None):
    """One (kernel, shape, dtype) row: the kernel against its plain
    version at a cut of lanes and rows (SHAPE_CHECK), bitwise, the words
    each lane asked for and the final states, the plain version timed
    there; the kernel timed (CUDA events) at the path's width
    (SHAPE_TIME) beside its bound there.  ``cuts``: (check, time) (lanes,
    steps) in their place."""
    from repro_torch.kernels import build, ops
    w, _, act, lattice, _ = operands
    unit = "mxu" if "mxu" in name else "vpu"
    i_dim, h_dim = w[0].shape
    seed = zlib.crc32(f"{name} {shape} {tag}".encode())
    check_cut, time_cut = cuts or (SHAPE_CHECK[(lattice is not None, unit)],
                                   SHAPE_TIME[(lattice is not None, unit)])
    kernel, plain, err, _, _, cut = shape_launch(
        torch, device, name, tag, operands, *check_cut, seed)
    want, plain_ms = timed_once(torch, plain)
    e = err(kernel(), want)
    del want
    kernel, _, _, lane_steps, n_bytes, time_cut = shape_launch(
        torch, device, name, tag, operands, *time_cut, seed + 1)
    ms = cuda_ms(torch, kernel, reps=3, warmup=1)
    if unit == "mxu":
        step = mxu_step_flops(i_dim, h_dim, lattice, act)
        b = mxu_bound(lane_steps, step, n_bytes, tag)
        ops_step = sum(step)
    else:
        base = (lattice_step_flops(lattice, h_dim) if lattice is not None
                else step_flops(i_dim, h_dim))
        extra = act_flops(h_dim, act)
        b = bound(lane_steps * base, n_bytes, tag,
                  f32_flops=lane_steps * extra)
        ops_step = base + extra
    errs[(name, shape, tag)] = e
    meta = {} if lattice is None else {"lattice_meta": np.array(
        [lattice[0], lattice[1], {"ring": 0, "grid": 1}[lattice[2]],
         lattice[3]], np.float32)}
    lib = build.library_path(
        key=ops.kernel_shapes({"w1": w[0], **meta}, unit)[0])
    print(f"check shapes {name} {shape} {act} {tag} ({cut}): "
          f"max_abs_err={e}, plain {plain_ms:.1f} ms; kernel at {time_cut} "
          f"{ms:.4f} ms (bound {b[0]:.4f} ms by {b[1]}, {ms / b[0]:.2f}x); "
          f"launches on the path {launches[(name, shape, tag)]}; card {card}")
    check(e == 0.0, f"shapes {name} {shape} {tag}: kernel != plain")
    kind = ("traj" if name.endswith("_traj") else "gang_stacked"
            if "stacked" in name else "gang_bits" if "gang" in name
            else "bits")
    form = (f"{shape} {unit} lattice" if lattice is not None and unit == "vpu"
            else f"{shape} mxu unit" if unit == "mxu" else f"{shape} vpu")
    return {"name": f"{name}/{act}/{tag}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chaotic_ann.cu",
            "replaces": REPLACES[f"chaotic_ann_{kind}"], "path": "shapes",
            "shape": re.sub(r"-(tanh|sigmoid)$", "", shape), "form": form,
            "library": lib.name,
            "launches": launches[(name, shape, tag)], "max_abs_err": e,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "library_ms": None, "ops_step": ops_step,
            "time_cut": time_cut, "plain_cut": cut}


def shape_w_cost(torch, device, rows, card) -> None:
    """W's cost: the lattice K1 at chen@grid24 (24 nodes in a 32-thread
    slot) beside chen@grid32 (32 nodes, the default library) at the same
    lanes and steps, each time over its ops bound; written into the
    grid24 K1 rows."""
    from repro_torch.core.ann import lattice_meta_tuple
    from repro_torch.kernels import chaotic_ann
    from repro_torch.prng.stream import default_params
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        t = {}
        for system in ("chen@grid24", "chen@grid32"):
            p = default_params(system=system)
            lat = lattice_meta_tuple(p["lattice_meta"])
            w = [torch.as_tensor(p[k], device=device)
                 for k in ("w1", "b1", "w2", "b2")]
            x = torch.zeros(SHAPE_W_LANES, p["w1"].shape[0], device=device,
                            dtype=dtype) + 0.25
            ms = cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_bits(
                *w, x, n_steps=SHAPE_W_STEPS, lattice=lat), reps=3,
                warmup=1)
            lane_steps = SHAPE_W_LANES * SHAPE_W_STEPS
            b = bound(lane_steps * lattice_step_flops(lat, p["w1"].shape[1]),
                      0.0, tag)
            t[system] = (ms, b[0])
        (m24, b24), (m32, b32) = t["chen@grid24"], t["chen@grid32"]
        print(f"shapes W's cost, lattice K1 {tag} ({SHAPE_W_LANES} lanes x "
              f"{SHAPE_W_STEPS} steps): grid24 {m24:.4f} ms ({m24 / b24:.2f}x "
              f"its ops bound), grid32 {m32:.4f} ms ({m32 / b32:.2f}x); time "
              f"ratio {m24 / m32:.3f}, bound ratio {b24 / b32:.3f}; card "
              f"{card}")
        for row in rows:
            if row["name"] == f"chaotic_ann_lattice_bits/relu/{tag}" and \
                    row["shape"] == "chen@grid24":
                row.update(w_cost_ms=m24, w_cost_bound_ms=b24,
                           grid32_ms=m32, grid32_bound_ms=b32)


def phase_shapes(torch, device, card, errs, ds=None):
    """Phase 14, every shape the reference's kernels take (the module's
    docstring), its nets trained on ``ds`` (phase 10's chen dataset; None:
    one made here).  Returns the ``kernels`` rows of every (kernel, shape,
    dtype) the path launched."""
    import tempfile
    from repro_torch.kernels import chaotic_ann
    t_phase = time.perf_counter()
    build_s = phase_shape_build(card)
    launches = {}
    nets = shape_nets(torch, device, card, ds)
    tmp = tempfile.TemporaryDirectory(prefix="shapes_")
    sys.path.insert(0, tmp.name)
    try:
        pkgs = shape_cores(torch, device, nets, pathlib.Path(tmp.name),
                           launches)
        shape_scalar_farms(torch, device, nets, pkgs, launches)
    finally:
        sys.path.remove(tmp.name)
        tmp.cleanup()
    shape_lattice_streams(torch, device, launches)
    shape_lattice_farm(torch, device, launches)
    t_checks = time.perf_counter()
    operands = shape_operands(torch, device, nets)
    rows = [shape_row(torch, device, name, shape, tag, operands[shape],
                      launches, card, errs)
            for name, shape, tag in sorted(launches)]
    shape_w_cost(torch, device, rows, card)
    # every kernel form on a shape outside the default library
    forms = {row["name"].split("/")[0] + "/" + row["name"].split("/")[2]
             for row in rows}
    missing = [f"{n}/{t}" for n in KERNELS for t in ("f32", "bf16")
               if f"{n}/{t}" not in forms]
    check(not missing, f"shapes: forms with no launch on a new shape: "
                       f"{missing}")
    check(any(r["shape"] == "chen@grid24" for r in rows)
          and any(r["shape"] == "hyperlorenz@grid4" for r in rows)
          and any(r["shape"] == "hyperlorenz@ring6" for r in rows),
          "shapes: no launch at 24 nodes, at 6 or on the 4-D base")
    wall = time.perf_counter() - t_phase
    print(f"shapes: {len(rows)} (kernel, shape, dtype) rows; checks "
          f"{time.perf_counter() - t_checks:.1f} s; phase {wall:.1f} s, "
          f"{build_s:.1f} s of it the shape libraries' build; loaded "
          f"{len(chaotic_ann._SHAPE_LIBS)} shape libraries")
    return rows

# ---------------------------------------------------------------------------
# Phase 17: lattices of more than 32 nodes (a lane slot across warps)
# ---------------------------------------------------------------------------

# the served wide lattices: chen@ring40 (40 nodes in a 64-thread slot of
# two warps, 24 idle), chen@grid64 (an 8 x 8 torus: row neighbours +-8,
# across warps), hyperlorenz@ring34 (the 4-16 base: 34 of 64 threads) and
# chen@ring128 (one slot a 128-thread CTA); chen@ring1024 at the kernel
# level only (the reference's DSE has no candidate there), a CTA of 1,024
WIDE_LATTICES = ("chen@ring40", "chen@grid64", "hyperlorenz@ring34",
                 "chen@ring128")
WIDE_FARM = "ring40"                     # the farm's lattice, four bases
WIDE_ACT_SHAPE = "chen@ring40"           # phase 10's nets expanded
WIDE_KERNEL_ONLY = "chen@ring1024"
# their shape libraries, the lattice and mxu families of each, built in
# one parallel build started before phase 2 (``WideBuild``), so that the
# nvcc processes run beside phases 2-3 and phase 17 waits on none
WIDE_KEYS = tuple((family, dims) for dims in (
    (3, 8, 40, 0), (3, 8, 64, 1), (4, 16, 34, 0), (3, 8, 128, 0),
    (3, 8, 1024, 0)) for family in ("lattice", "mxu"))
# each (kernel, shape, dtype) row's check against its plain version and
# its timing, (lanes, steps) by unit (timed as phase 14 times its
# lattices); at 1,024 nodes (n_nodes >= 512) the kernel-level cut: 64
# lanes x 2 steps checked, 16,384 x 32 timed (over 4 steps the prologue's
# weight loads from the 100 MB expanded operands took most of the time)
WIDE_CHECK = {"vpu": (1_024 + 37, 8), "mxu": (256 + 37, 4)}
WIDE_TIME = {"vpu": (65_536, 64), "mxu": (65_536, 16)}
WIDE_BIG_CHECK, WIDE_BIG_TIME = (64, 2), (16_384, 32)
# the mxu K2 iterated in part (a): lanes, steps
WIDE_ITERATED = (256 + 37, 4)
# the exchange's cost: the lattice K1 at chen@grid64 (two warps a slot,
# neighbours through shared memory) beside chen@grid32 (one warp,
# shuffles; the default library), lanes x steps
# (the three configurations timed in turns, WIDE_X_ROUNDS rounds of
# WIDE_X_REPS calls each, forward and back, and the medians compared: one
# pass of 3 calls each put the ratio 0.69-1.30 in three calls)
WIDE_X_LANES, WIDE_X_STEPS = 16_384, 64
WIDE_X_ROUNDS, WIDE_X_REPS = 6, 10
WIDE_GANGS = ("chaotic_ann_lattice_gang_bits",
              "chaotic_ann_lattice_gang_stacked", "chaotic_ann_mxu_gang_bits")
# the CUDA kernels of the wide libraries, whose registers and spills the
# phase prints
WIDE_KERNEL_NAMES = tuple(
    p + k for k in ("lattice_bits_kernel", "lattice_traj_kernel",
                    "lattice_gang_bits_kernel", "lattice_gang_stacked_kernel")
    for p in ("", "bf16x2_")) + tuple(
    p + k for k in ("bits_kernel", "traj_kernel", "gang_bits_kernel")
    for p in ("mxu_x2_", "bf16x2_mxu_"))


class WideBuild:
    """Phase 17's shape libraries (WIDE_KEYS), built in one parallel build
    on a thread of its own from construction: ``build_libraries`` starts
    every nvcc process at once and polls them, so the thread waits on
    child processes and the phases run on.  ``join`` returns ({key:
    (seconds, nvcc's log)}, the build's wall); ``main`` joins it before
    exiting whatever happened, so no nvcc outlives the script."""

    def __init__(self):
        import threading
        from repro_torch.kernels import build
        self.result, self.error, self.wall = {}, None, 0.0
        t0 = time.perf_counter()

        def run():
            try:
                self.result = build.build_libraries(WIDE_KEYS)
            except BaseException as e:       # re-raised by join
                self.error = e
            self.wall = time.perf_counter() - t0

        self.thread = threading.Thread(target=run, name="wide-build",
                                       daemon=True)
        self.thread.start()

    def join(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.result, self.wall


def wide_build_report(wide_build, card) -> float:
    """Waits for phase 17's build, loads its libraries through ``prepare``
    (which must build nothing more) and prints each library's seconds from
    the build's start, its registers and spills, and the wall."""
    from repro_torch.kernels import build, chaotic_ann
    t0 = time.perf_counter()
    built, wall = wide_build.join()
    waited = time.perf_counter() - t0
    check(not any(chaotic_ann.prepare(WIDE_KEYS).values()),
          "prepare rebuilt a wide library the build had built")
    for key in WIDE_KEYS:
        secs, log = built.get(key, (0.0, ""))
        print(f"wide library {shape_label(key)} "
              f"({build.library_path(key=key).name}): "
              + (f"built in {secs:.1f} s; ptxas: {register_report(log)}"
                 if log else "reused"))
        for name in WIDE_KERNEL_NAMES:
            if f"{len(name)}{name}I" in log:
                print(f"  {kernel_registers(log, name)}")
    print(f"wide libraries: {len(built)} built in {wall:.1f} s, one "
          f"parallel build beside phases 2-3 (phase 17 waited "
          f"{waited:.1f} s); card {card}")
    return wall


def wide_operands(torch, device, p, act="relu"):
    """A lattice's row operands from its params ``p``: (weights, a gang of
    the net and a scaled copy, activation, descriptor, coupling)."""
    from repro_torch.core.ann import lattice_meta_tuple
    w = [torch.as_tensor(np.asarray(p[k], np.float32), device=device)
         for k in ("w1", "b1", "w2", "b2")]
    return (w, [torch.stack([t, t * 0.9375]) for t in w], act,
            lattice_meta_tuple(p["lattice_meta"]),
            torch.as_tensor(p["coupling"], device=device))


def wide_cuts(n_nodes: int, unit: str):
    """A wide row's (check, time) cuts: (lanes, steps) each."""
    if n_nodes >= 512:
        return WIDE_BIG_CHECK, WIDE_BIG_TIME
    return WIDE_CHECK[unit], WIDE_TIME[unit]


def wide_kernel_launches(torch, device, launches, names, shape, operands):
    """Each kernel of ``names`` in both dtypes at its check cut, the
    launch counters zeroed just before and read just after each call (it
    must launch that kernel and no other), its launches attributed to
    (shape, dtype); ``shape_row`` holds each against its plain version."""
    n_nodes = operands[3][0]
    for name in names:
        unit = "mxu" if "mxu" in name else "vpu"
        for tag in ("f32", "bf16"):
            kernel = shape_launch(torch, device, name, tag, operands,
                                  *wide_cuts(n_nodes, unit)[0], 7)[0]
            shape_counted(torch, launches, (shape, tag), kernel, {name},
                          f"wide {shape} {name} {tag}")


def wide_x_cost(torch, device, rows, card) -> None:
    """The exchange's cost: the lattice K1 at chen@grid64 (a slot of two
    warps: neighbours +-8 through shared memory, one barrier a step, the
    fold's posts) beside chen@grid32 (one warp, shuffles) at the same
    lanes and steps, per node-step, each over its ops bound; and beside
    grid32 at twice the lanes (the same threads and node-steps as grid64:
    at equal lanes grid64 has twice grid32's threads to hide latency with);
    written into the grid64 K1 rows."""
    from repro_torch.core.ann import lattice_meta_tuple
    from repro_torch.kernels import chaotic_ann
    from repro_torch.prng.stream import default_params
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        calls, t = {}, {}
        for system, lanes in (("chen@grid64", WIDE_X_LANES),
                              ("chen@grid32", WIDE_X_LANES),
                              ("chen@grid32", 2 * WIDE_X_LANES)):
            p = default_params(system=system)
            lat = lattice_meta_tuple(p["lattice_meta"])
            w = [torch.as_tensor(p[k], device=device)
                 for k in ("w1", "b1", "w2", "b2")]
            x = torch.zeros(lanes, p["w1"].shape[0], device=device,
                            dtype=dtype) + 0.25
            calls[(system, lanes)] = (
                lambda w=w, x=x, lat=lat: chaotic_ann.chaotic_ann_bits(
                    *w, x, n_steps=WIDE_X_STEPS, lattice=lat),
                lanes * WIDE_X_STEPS * lat[0],
                bound(lanes * WIDE_X_STEPS
                      * lattice_step_flops(lat, p["w1"].shape[1]), 0.0,
                      tag)[0])
        samples = {key: [] for key in calls}
        for r in range(WIDE_X_ROUNDS):
            for key in list(calls)[::-1 if r % 2 else 1]:
                samples[key].append(cuda_ms(torch, calls[key][0],
                                            reps=WIDE_X_REPS, warmup=1))
        for key, (_, node_steps, b) in calls.items():
            ms = float(np.median(samples[key]))
            t[key] = (ms, b, ms * 1e6 / node_steps)
            print(f"wide exchange's cost {tag} {key[0]} at {key[1]} lanes: "
                  f"{WIDE_X_ROUNDS} x {WIDE_X_REPS} calls, median {ms:.4f} "
                  f"ms, range {min(samples[key]):.4f}-"
                  f"{max(samples[key]):.4f}")
        m64, b64, n64 = t[("chen@grid64", WIDE_X_LANES)]
        m32, b32, n32 = t[("chen@grid32", WIDE_X_LANES)]
        m2, b2, n2 = t[("chen@grid32", 2 * WIDE_X_LANES)]
        print(f"wide exchange's cost, lattice K1 {tag} ({WIDE_X_LANES} lanes "
              f"x {WIDE_X_STEPS} steps): grid64 {m64:.4f} ms ({m64 / b64:.2f}x "
              f"its ops bound, {n64:.4f} ns a node-step), grid32 {m32:.4f} "
              f"ms ({m32 / b32:.2f}x, {n32:.4f} ns a node-step); per "
              f"node-step grid64 / grid32 {n64 / n32:.3f}; grid32 at "
              f"{2 * WIDE_X_LANES} lanes (grid64's threads) {m2:.4f} ms "
              f"({m2 / b2:.2f}x, {n2:.4f} ns a node-step), grid64 / it "
              f"{n64 / n2:.3f}; card {card}")
        for row in rows:
            if row["name"] == f"chaotic_ann_lattice_bits/relu/{tag}" and \
                    row["shape"] == "chen@grid64":
                row.update(x_cost_ms=m64, x_cost_bound_ms=b64,
                           x_cost_ns_node_step=n64, grid32_ms=m32,
                           grid32_bound_ms=b32, grid32_ns_node_step=n32,
                           grid32_2x_lanes_ms=m2,
                           grid32_2x_lanes_ns_node_step=n2)


def phase_wide(torch, device, card, errs, chen_nets, wide_build):
    """Phase 17, lattices of more than 32 nodes (the module's docstring):
    (a) the wide lattices served, (b) the ring40 farm, (c) tanh and
    sigmoid at ring40, (d) chen@ring1024 at the kernel level, (e) the
    gang forms at the other three wide shapes at the kernel level; then a
    row for every (kernel, shape, dtype) launched and the exchange's
    cost.  ``chen_nets`` are phase 10's {activation: net}.  Returns the
    rows (path "wide")."""
    from repro_torch.kernels import chaotic_ann
    from repro_torch.prng.stream import default_params
    t_phase = time.perf_counter()
    build_s = wide_build_report(wide_build, card)
    launches = {}
    t0 = time.perf_counter()
    shape_lattice_streams(torch, device, launches, WIDE_LATTICES,
                          WIDE_ITERATED)
    t1 = time.perf_counter()
    shape_lattice_farm(torch, device, launches, WIDE_FARM)
    t2 = time.perf_counter()
    operands = {s: wide_operands(torch, device, default_params(system=s))
                for s in WIDE_LATTICES + (WIDE_KERNEL_ONLY,)}
    for act in PAPER_ACTIVATIONS:
        bundle, _, _ = expand_net(chen_nets[act], WIDE_ACT_SHAPE)
        shape = f"{WIDE_ACT_SHAPE}-{act}"
        operands[shape] = wide_operands(torch, device, bundle, act)
        wide_kernel_launches(torch, device, launches,
                             ("chaotic_ann_lattice_bits",
                              "chaotic_ann_mxu_bits"), shape,
                             operands[shape])
    wide_kernel_launches(torch, device, launches,
                         ("chaotic_ann_lattice_bits", "chaotic_ann_mxu_bits"),
                         WIDE_KERNEL_ONLY, operands[WIDE_KERNEL_ONLY])
    for shape in WIDE_LATTICES:
        if shape != f"chen@{WIDE_FARM}":
            wide_kernel_launches(torch, device, launches, WIDE_GANGS, shape,
                                 operands[shape])
    t3 = time.perf_counter()
    rows = []
    for name, shape, tag in sorted(launches):
        unit = "mxu" if "mxu" in name else "vpu"
        rows.append(shape_row(torch, device, name, shape, tag,
                              operands[shape], launches, card, errs,
                              wide_cuts(operands[shape][3][0], unit)))
        rows[-1]["path"] = "wide"
        rows[-1]["slot_width"] = chaotic_ann.slot_width(operands[shape][3][0])
    wide_x_cost(torch, device, rows, card)
    have = {(r["name"], r["shape"]) for r in rows}
    missing = [f"{n}/relu/{t} {s}" for s in WIDE_LATTICES
               for n in KERNELS if "lattice" in n or "mxu" in n
               for t in ("f32", "bf16")
               if (f"{n}/relu/{t}", s) not in have]
    missing += [f"{n}/{a}/{t} {s}" for s, acts in (
        (WIDE_KERNEL_ONLY, ("relu",)), (WIDE_ACT_SHAPE, PAPER_ACTIVATIONS))
        for a in acts for n in ("chaotic_ann_lattice_bits",
                                "chaotic_ann_mxu_bits")
        for t in ("f32", "bf16") if (f"{n}/{a}/{t}", s) not in have]
    check(not missing, f"wide: forms with no launch: {missing}")
    wall = time.perf_counter() - t_phase
    print(f"wide: {len(rows)} (kernel, shape, dtype) rows; served "
          f"lattices {t1 - t0:.1f} s, farm {t2 - t1:.1f} s, kernel-level "
          f"launches {t3 - t2:.1f} s, rows {time.perf_counter() - t3:.1f} "
          f"s; phase {wall:.1f} s (the build {build_s:.1f} s beside "
          f"phases 2-3); card {card}")
    return rows


def shard_meshes(torch) -> dict:
    """Phase 15's meshes by label: cuda:0 listed k times for each of
    SHARD_REPEATS, and every card when more than one is visible."""
    from repro_torch.distributed.sharding import DeviceMesh
    meshes = {f"cuda:0 x{k}": DeviceMesh(["cuda:0"] * k)
              for k in SHARD_REPEATS}
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        meshes[f"{n_cards} cards"] = DeviceMesh(
            [f"cuda:{i}" for i in range(n_cards)])
    return meshes


def shard_flush(torch, flush, mesh, want, what, farm=None):
    """One flush of a meshed farm or service, the launch counters zeroed
    just before and read just after; its words must equal ``want`` (the
    unsharded run's).  Prints the wall, the planner's decision (a farm),
    the kernels launched, the shards run on each mesh entry and the
    device-to-device bytes copied.  Returns (launches, shards by entry)."""
    from repro_torch.kernels import chaotic_ann
    dec0 = None if farm is None else farm.plan_decisions
    shards0, bytes0 = list(mesh.shard_launches), mesh.copied_bytes
    zero_launches(chaotic_ann)
    t0 = time.perf_counter()
    out = flush()
    for d in {d for d in mesh.devices}:
        torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    got = {k: v for k, v in read_launches(chaotic_ann).items() if v}
    shards = [a - b for a, b in zip(mesh.shard_launches, shards0)]
    decisions = ({} if farm is None else
                 {k: v - dec0[k] for k, v in farm.plan_decisions.items()
                  if v != dec0[k]})
    print(f"{what}: wall {wall * 1e3:.1f} ms; decisions {decisions}; "
          f"kernel launches {got}; shards by entry {shards}; "
          f"device-to-device bytes {mesh.copied_bytes - bytes0}")
    same = (same_words(out, want) if farm is not None else
            set(out) == set(want)
            and all(np.array_equal(out[k], want[k]) for k in out))
    check(same, f"{what}: words differ from the unsharded run")
    return got, shards


def fit_report(model, c) -> str:
    """A cost model's terms in seconds (cycles x sec_per_cycle)."""
    spc = model.sec_per_cycle
    return (f"launch {model.launch_overhead_cycles * spc * 1e6:.3f} us, "
            f"cell {model.cell_overhead_cycles * spc * 1e9:.1f} ns, "
            f"step of one {c.s_block}-lane block "
            f"{model.step_cycles(c) * spc * 1e9:.2f} ns, stacked scale "
            f"{model.stacked_step_scale:.3f}, freeze row "
            f"{model.freeze_row_cycles * spc * 1e9:.1f} ns, device fee "
            f"{model.cross_dev_overhead_cycles * spc * 1e6:.3f} us "
            f"(sec_per_cycle {spc:.4g})")


def synced_ms(torch, fn, cards, reps: int) -> float:
    """Median wall of ``reps`` calls of ``fn`` (after one untimed call),
    each ending in ``torch.cuda.synchronize`` of every card in ``cards``:
    what ``GangCostModel.fit`` times, and the one clock that spans the
    shards of a mesh over several cards."""
    def sync():
        for d in cards:
            torch.cuda.synchronize(d)
    fn()
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[reps // 2] * 1e3


def shard_times(torch, device, farm, meshes, tag, card, fitted) -> None:
    """The sharded K4 and K3 calls at F1's shape (the farm's four 3-8-3
    pools, FARM_WORDS a client) on each mesh of more than one entry,
    beside the unsharded K4 and K3 on the same inputs: device times by
    CUDA events on a mesh of one card (the shards, the slices and the
    gathers included), each over the unsharded launch's bound; on a mesh
    over several cards, walls with every card synchronised (events time
    one card's stream only).  Then ``fitted``'s price of the unsharded
    K4 call, F1's stacked launch, against its wall as the fit times it
    (through ``ops``, every call synchronised):
    within SHARD_FIT_FACTOR either way; the K3 call's ratio is printed."""
    from repro_torch.kernels import chaotic_ann, ops
    svcs = [farm.services[c] for c in GANGS["3-8"]]
    w = [torch.stack([s.params[k] for s in svcs])
         for k in ("w1", "b1", "w2", "b2")]
    n_cores, i_dim, h_dim = w[0].shape
    s_pool = FARM_CLIENTS * LANES_PER_CLIENT
    x0s = torch.stack([s.pool_x[:s_pool] for s in svcs]).contiguous()
    x0c = x0s.reshape(n_cores * s_pool, i_dim)
    offs = torch.zeros((n_cores, s_pool), dtype=torch.int64, device=device)
    cfg = svcs[0].config
    blocks = s_pool // cfg.s_block
    core_map = np.repeat(np.arange(n_cores), blocks)
    rows = FARM_WORDS // LANES_PER_CLIENT
    kw = dict(n_steps=2 * rows)
    k3_kw = dict(kw, s_block=cfg.s_block, t_block=cfg.t_block,
                 unroll=cfg.unroll)
    item = x0s.element_size()
    n_words = n_cores * s_pool * rows
    lim = bound(n_words * 2 * step_flops(i_dim, h_dim),
                2 * n_cores * s_pool * i_dim * item + n_cores * s_pool * 8
                + n_cores * (2 * i_dim * h_dim + h_dim + i_dim) * item
                + n_words * 4, tag)

    def k4(mesh=None):
        if mesh is None:
            return lambda: chaotic_ann.chaotic_ann_gang_stacked(
                *w, x0s, offs, **kw)
        return lambda: chaotic_ann.chaotic_ann_gang_stacked_sharded(
            *w, x0s, offs, mesh=mesh, **kw)

    def k3(mesh=None):
        if mesh is None:
            return lambda: chaotic_ann.chaotic_ann_gang_bits(
                *w, x0c, core_map, offs.reshape(-1), **k3_kw)
        return lambda: chaotic_ann.chaotic_ann_gang_bits_sharded(
            *w, x0c, core_map, offs.reshape(-1), mesh=mesh, **k3_kw)

    t = {"K4": cuda_ms(torch, k4(), reps=10, warmup=2),
         "K3": cuda_ms(torch, k3(), reps=10, warmup=2)}
    walls = {}
    for name, mesh in meshes.items():
        if len(mesh.devices) < 2:
            continue
        cards = sorted({d.index for d in mesh.devices})
        for kname, make in (("K4", k4), ("K3", k3)):
            if len(cards) > 1:
                walls[f"{kname} on {name}"] = synced_ms(
                    torch, make(mesh), cards, reps=10)
            else:
                t[f"{kname} on {name}"] = cuda_ms(torch, make(mesh), reps=10,
                                                  warmup=2)
    print(f"sharded device times {tag} (F1's shape, {n_cores} x {s_pool} "
          f"lanes x {rows} rows, s_block {cfg.s_block}; bound "
          f"{lim[0]:.4f} ms by {lim[1]}): "
          + ", ".join(f"{k} {v:.4f} ms ({v / lim[0]:.2f}x)"
                      for k, v in t.items())
          + "".join(f", {k} {v:.4f} ms (wall, every card synchronised)"
                    for k, v in walls.items()) + f"; card {card}")
    price = {"K4": fitted.seconds(fitted.gang_cost(
                 cfg, [rows] * n_cores, [blocks] * n_cores,
                 [s_pool] * n_cores, layout="stacked")) * 1e3,
             "K3": fitted.seconds(fitted.gang_cost(
                 cfg, [rows] * n_cores, [blocks] * n_cores,
                 [s_pool] * n_cores, layout="concat")) * 1e3}
    # through ops, as the farm calls them and the fit times its launches
    gang = dict(zip(("w1", "b1", "w2", "b2"), w))
    timed = {"K4": synced_ms(torch, lambda: ops.chaotic_bits_gang_stacked(
                 gang, x0s, 2 * rows, offs, config=cfg), [device],
                 reps=SHARD_FIT_REPS),
             "K3": synced_ms(torch, lambda: ops.chaotic_bits_gang(
                 gang, x0c, 2 * rows, offs.reshape(-1), core_map=core_map,
                 config=cfg), [device], reps=SHARD_FIT_REPS)}
    ratio = {k: price[k] / timed[k] for k in price}
    base = type(fitted)()
    base_k4 = base.seconds(base.gang_cost(
        cfg, [rows] * n_cores, [blocks] * n_cores, [s_pool] * n_cores,
        layout="stacked")) * 1e3
    print(f"sharded fit {tag}: the fitted price of F1's stacked launch "
          f"{price['K4']:.4f} ms against its wall {timed['K4']:.4f} ms "
          f"(x{ratio['K4']:.3f}; limit x{SHARD_FIT_FACTOR} either way; the "
          f"default model's {base_k4:.4f} ms, x{base_k4 / timed['K4']:.3f}); "
          f"the concat launch at that shape {price['K3']:.4f} ms against "
          f"{timed['K3']:.4f} ms (x{ratio['K3']:.3f}); card {card}")
    check(1 / SHARD_FIT_FACTOR <= ratio["K4"] <= SHARD_FIT_FACTOR,
          f"sharded fit {tag}: the fitted price of F1's stacked launch is "
          f"x{ratio['K4']:.3f} its time")


def shard_mixed(torch, mesh, name, card) -> None:
    """A farm on the index-less "cuda" device (the services' default) with
    chen unmeshed and lorenz on ``mesh``, flushed twice, so the unmeshed
    core's launch follows a sharded one: on a mesh over several cards the
    thread's current device must not move to another card, and the words
    must be the unmeshed farm's on any mesh."""
    from repro_torch.prng.stream import default_params
    from repro_torch.serve.farm import OscillatorFarm
    cur = torch.cuda.current_device()
    flat, mixed = OscillatorFarm(device="cuda"), OscillatorFarm(device="cuda")
    for f in (flat, mixed):
        f.add_core("chen", default_params(system="chen"))
        f.add_core("lorenz", default_params(system="lorenz"),
                   mesh=mesh if f is mixed else None)
    clients = [f"m{i}" for i in range(2 * len(mesh.devices))]
    register_all(torch, (flat, mixed), clients, 7000)
    for k in range(2):
        request_all((flat, mixed), {c: FARM_WORDS for c in flat.cores})
        check(same_words(mixed.flush(), flat.flush()),
              f"sharded mixed farm on {name}, flush {k}: words differ from "
              f"the unmeshed farm")
        check(torch.cuda.current_device() == cur,
              f"sharded mixed farm on {name}, flush {k}: the current device "
              f"moved from {cur} to {torch.cuda.current_device()}")
    print(f"sharded mixed farm (chen unmeshed on 'cuda', lorenz on {name}): "
          f"two flushes bitwise the unmeshed farm's, current device still "
          f"{cur}; card {card}")


def phase_sharded(torch, device, card) -> dict:
    """Phase 15: the farm across devices.  Returns {(kernel, dtype tag):
    launches in the phase's meshed runs}."""
    from repro_torch.core.dse import GangCostModel
    from repro_torch.prng.stream import default_params
    from repro_torch.serve.prng_service import PRNGService

    t_phase = time.perf_counter()
    meshes = shard_meshes(torch)
    print(f"sharded: meshes {', '.join(f'{k}: {m}' for k, m in meshes.items())}"
          f"; card {card}")
    launches: dict = {}

    def add(got, tag):
        for k, v in got.items():
            launches[(k, tag)] = launches.get((k, tag), 0) + v

    clients = [f"c{i:03d}" for i in range(FARM_CLIENTS)]
    lanes = FARM_CLIENTS * LANES_PER_CLIENT
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        # the fitted cost model: the farm's 3-8-3 candidate, the device fee
        # on the 4-entry mesh
        cand = make_farm(torch, device, tag).services["chen"].config
        t0 = time.perf_counter()
        fitted = GangCostModel.fit(cand, device=device,
                                   n_cores=len(GANGS["3-8"]),
                                   lanes=lanes, reps=SHARD_FIT_REPS,
                                   mesh=meshes[SHARD_FIT_MESH])
        print(f"sharded fit {tag} ({cand}, {lanes} lanes a pool, "
              f"{time.perf_counter() - t0:.2f} s): "
              f"{fit_report(fitted, cand)}; default: "
              f"{fit_report(GangCostModel(), cand)}; card {card}")
        check(fitted != GangCostModel(),
              f"sharded fit {tag}: the doubled launch was not slower, the "
              f"defaults came back")
        # the committed farm, unsharded (the words every run must equal),
        # on each mesh, and under the fitted model unsharded and on 4
        runs = {"unsharded": (make_farm(torch, device, tag), None)}
        for name, mesh in meshes.items():
            runs[name] = (make_farm(torch, device, tag, mesh=mesh), mesh)
        runs["unsharded, fitted"] = (make_farm(torch, device, tag,
                                               cost_model=fitted), None)
        runs[f"{SHARD_FIT_MESH}, fitted"] = (
            make_farm(torch, device, tag, mesh=meshes[SHARD_FIT_MESH],
                      cost_model=fitted), meshes[SHARD_FIT_MESH])
        farms = [f for f, _ in runs.values()]
        register_all(torch, farms, clients, 0)
        cores = farms[0].cores
        hot = {c: HOT_WORDS if c == "chen" else COLD_WORDS for c in cores}
        for label, words in (("F1", {c: FARM_WORDS for c in cores}),
                             ("F2", hot), ("F3", {c: FARM_WORDS for c in cores})):
            if label == "F3":              # unequal pools: one more client
                for f in farms:
                    f.register("lorenz", f"c{FARM_CLIENTS}", seed=99)
            request_all(farms, words)
            want = None
            for name, (farm, mesh) in runs.items():
                if mesh is None:           # unmeshed: the words to equal
                    dec0 = farm.plan_decisions
                    t0 = time.perf_counter()
                    out = farm.flush()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    want = out if want is None else want
                    check(same_words(out, want),
                          f"sharded farm {tag} {label} {name}: words differ")
                    print(f"sharded farm {tag} {label} {name}: wall "
                          f"{wall * 1e3:.1f} ms; decisions "
                          f"{ {k: v - dec0[k] for k, v in farm.plan_decisions.items() if v != dec0[k]} }")
                    continue
                got, _ = shard_flush(torch, farm.flush, mesh, want,
                                     f"sharded farm {tag} {label} on {name}",
                                     farm)
                add(got, tag)
                n_dev = len(mesh.devices)
                if "fitted" in name or lanes % n_dev:
                    continue
                if label == "F1":
                    check(got.get("chaotic_ann_gang_stacked") == n_dev
                          and got.get("chaotic_ann_bits") == n_dev,
                          f"sharded farm {tag} F1 on {name}: expected a K4 "
                          f"and a K1 launch a shard, got {got}")
                elif label == "F3":
                    check(got.get("chaotic_ann_gang_bits") == n_dev,
                          f"sharded farm {tag} F3 on {name}: expected a K3 "
                          f"launch a shard, got {got}")
        if tag == "f32":
            # a snapshot of the 4-shard farm with requests pending: refused
            # by an unsharded farm, restored there with replan
            m4 = runs[SHARD_FIT_MESH][0]
            request_all((m4,), {c: FARM_WORDS for c in cores})
            snap = m4.snapshot()
            flat = make_farm(torch, device, tag)
            try:
                flat.restore(snap)
                refused = False
            except ValueError:
                refused = True
            check(refused, "sharded: an unsharded farm took the 4-shard "
                           "farm's snapshot without replan")
            flat.restore(snap, on_topology_mismatch="replan")
            check(same_words(m4.flush(), flat.flush()),
                  "sharded: the replanned restore differs from the 4-shard "
                  "farm")
            print(f"sharded farm {tag}: the {SHARD_FIT_MESH} snapshot refused "
                  f"by an unsharded farm, restored with replan, its next "
                  f"flush bitwise")

        shard_times(torch, device, runs["unsharded"][0], meshes, tag, card,
                    fitted)
        if tag == "f32":                   # the widest mesh of cards
            name = max(meshes, key=lambda k: (
                len({d.index for d in meshes[k].devices}),
                len(meshes[k].devices) == 2))
            shard_mixed(torch, meshes[name], name, card)

        # the served chen at full width
        params = default_params(system="chen")
        svcs = {"unsharded": (PRNGService(
            params, lanes_per_client=LANES_PER_CLIENT, dtype=dtype,
            device=device), None)}
        for name, mesh in meshes.items():
            if len(mesh.devices) > 1:
                svcs[name] = (PRNGService(
                    params, lanes_per_client=LANES_PER_CLIENT, dtype=dtype,
                    mesh=mesh), mesh)
        t0 = time.perf_counter()
        for svc, _ in svcs.values():
            for i in range(N_CLIENTS):
                svc.register(f"s{i:03d}", seed=i)
        torch.cuda.synchronize()
        print(f"sharded served chen {tag}: {N_CLIENTS} clients x "
              f"{LANES_PER_CLIENT} lanes registered on {len(svcs)} services "
              f"in {time.perf_counter() - t0:.2f} s")
        for k in range(SHARD_SERVED_FLUSHES):
            for svc, _ in svcs.values():
                for i in range(N_CLIENTS):
                    svc.request(f"s{i:03d}", SHARD_SERVED_WORDS)
            t0 = time.perf_counter()
            want = svcs["unsharded"][0].flush()
            torch.cuda.synchronize()
            print(f"sharded served chen {tag} flush {k} unsharded: wall "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
            for name, (svc, mesh) in list(svcs.items())[1:]:
                got, _ = shard_flush(
                    torch, svc.flush, mesh, want,
                    f"sharded served chen {tag} flush {k} on {name} "
                    f"({N_CLIENTS * SHARD_SERVED_WORDS} words)")
                add(got, tag)
                check(got == {"chaotic_ann_bits": len(mesh.devices)},
                      f"sharded served chen {tag} on {name}: expected a K1 "
                      f"launch a shard, got {got}")

        # the lattice and mxu farms at F1 and F3 on two shards
        mesh = meshes[SHARD_SIDE_MESH]
        for unit, make in (("vpu", make_lattice_farm), ("mxu", make_mxu_farm)):
            flat, meshed = make(device, dtype), make(device, dtype, mesh=mesh)
            register_all(torch, (flat, meshed), clients, 5000)
            n_words = LATTICE_WORDS if unit == "vpu" else MXU_WORDS
            for label in ("F1", "F3"):
                if label == "F3":
                    for f in (flat, meshed):
                        f.register("lorenz@ring32", f"c{FARM_CLIENTS}",
                                   seed=99)
                request_all((flat, meshed), {c: n_words for c in flat.cores})
                got, _ = shard_flush(
                    torch, meshed.flush, mesh, flat.flush(),
                    f"sharded {unit} lattice farm {tag} {label} on "
                    f"{SHARD_SIDE_MESH}", meshed)
                add(got, tag)
                lat = ("chaotic_ann_mxu_gang_bits" if unit == "mxu"
                       else "chaotic_ann_lattice_gang_stacked" if label == "F1"
                       else "chaotic_ann_lattice_gang_bits")
                check(got.get(lat, 0) >= len(mesh.devices),
                      f"sharded {unit} lattice farm {tag} {label}: expected "
                      f"{lat} on every shard, got {got}")
    for name in ("chaotic_ann_bits", "chaotic_ann_gang_bits",
                 "chaotic_ann_gang_stacked"):
        check(all(launches.get((name, tag), 0) > 0 for tag in ("f32", "bf16")),
              f"sharded: {name} not launched on a mesh ({launches})")
    print(f"sharded: phase {time.perf_counter() - t_phase:.1f} s; launches "
          f"on the meshes {sorted(launches.items())}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build    # fails outside the repo

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    log = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({build.SOURCE} {'compiled' if log else 'reused'})")
    if log:
        print(f"ptxas: {register_report(log)}")
    # the SASS counts: cuobjdump runs beside the phases, read at the end
    sass = sass_dump_start(build.library_path(build.SOURCE))
    wide_build = WideBuild()
    try:
        return run_phases(torch, device, card, log, sass, wide_build)
    finally:
        sass_dump_stop(sass)
        wide_build.thread.join()     # no nvcc outlives the script


def lm_serve(torch, device, card, arch, n_layers):
    """Phase 16 (a)/(c): one arch served at full width."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tf.init(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_PROMPTS, LM_PROMPT_LEN),
                           generator=gen).to(device)
    max_len = LM_PROMPT_LEN + LM_NEW
    what = f"lm {arch} ({cfg.n_layers} layers, {cfg.dtype})"
    with torch.no_grad():
        t0 = time.perf_counter()
        _, aux = tf.forward(cfg, model, prompt)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        t0 = time.perf_counter()
        last, state = engine.prefill(cfg, model, prompt, max_len)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        ref, _ = tf.forward(cfg, model, prompt, last_only=True)
        last32, ref32 = last.float(), ref[:, 0].float()
        check(bool(torch.isfinite(last32).all()), f"{what}: prefill logits "
                                                 f"not finite")
        check(tuple(last.shape) == (LM_PROMPTS, cfg.vocab_size),
              f"{what}: prefill logits of shape {tuple(last.shape)}")
        err = float((last32 - ref32).abs().max())
        scale = float(ref32.abs().max())
        check(err <= LM_LAST_TOL * scale,
              f"{what}: prefill's last logits differ from "
              f"forward(last_only=True) by {err} (max {scale})")
        tok = torch.argmax(last, dim=-1)[:, None]
        toks, dropped = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LM_NEW):
            logits, state, daux = tf.decode_step(cfg, model, state, tok,
                                                 return_aux=True)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            toks.append(tok[:, 0])
            if daux:
                dropped.append(daux["dropped_frac"])
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        decoded = torch.stack(toks, dim=1)
        # the generation repeated, through the engine's own loop
        again = engine.greedy_generate(cfg, model, prompt, LM_NEW, max_len)
    check(torch.equal(again, decoded),
          f"{what}: greedy_generate gave other tokens than prefill + "
          f"decode_step")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    line = (f"{what}: init {t_init:.2f} s, {cfg.n_params() / 1e9:.3f} B "
            f"params; forward {LM_PROMPTS} x {LM_PROMPT_LEN} "
            f"{t_fwd * 1e3:.1f} ms ({LM_PROMPTS * LM_PROMPT_LEN / t_fwd:.0f} "
            f"tokens/s); prefill (forward + replay) {t_prefill * 1e3:.1f} ms "
            f"({LM_PROMPTS * LM_PROMPT_LEN / t_prefill:.0f} tokens/s); "
            f"decode {t_dec / LM_NEW * 1e3:.2f} ms a step of {LM_PROMPTS} "
            f"tokens; last logits vs forward(last_only) {err:.3g} of "
            f"{scale:.3g}; generation repeated, equal; peak "
            f"{peak:.2f} GiB")
    if cfg.is_moe:
        dec_drop = float(torch.stack(dropped).max())
        check(dec_drop == 0.0, f"{what}: decode dropped {dec_drop}")
        line += (f"; prefill dropped_frac {float(aux['dropped_frac']):.4f}, "
                 f"decode 0")
    print(f"{line}; card {card}")
    del model, state
    torch.cuda.empty_cache()


def lm_card_vs_cpu(torch, device, card):
    """Phase 16 (b): llama3_2_3b's width at 2 layers in f32, one parameter
    set on the CPU and on the card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_config("llama3_2_3b"),
                              n_layers=LM_CPU_LAYERS, dtype="float32")
    t0 = time.perf_counter()
    model = tf.init(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, LM_CPU_TOKENS, generator=gen)
    with torch.no_grad():
        want, _ = tf.forward(cfg, model, toks)
        got, _ = tf.forward(cfg, model.to(device), toks.to(device))
    got = got.cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"lm card vs CPU (llama3_2_3b width, {LM_CPU_LAYERS} layers, f32, "
          f"TF32 off, {LM_CPU_TOKENS[0]} x {LM_CPU_TOKENS[1]} tokens): max "
          f"|logits diff| {err:.3g} of {scale:.3g} "
          f"({time.perf_counter() - t0:.1f} s); card {card}")
    check(bool(torch.isfinite(got).all()) and err <= LM_CPU_TOL * scale,
          f"lm card vs CPU: logits differ by {err} (max {scale})")
    del model
    torch.cuda.empty_cache()


def lm_train(torch, device, card) -> int:
    """Phase 16 (d): returns K1's launches in the training run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import chaotic_ann
    from repro_torch.launch.train import train
    from repro_torch.prng import default_stream

    t = LM_TRAIN
    cfg = dataclasses.replace(get_config("llama3_2_3b"), n_layers=t["layers"],
                              remat=True)
    # the shuffle's stream made and drawn once alone, outside the counted
    # run: its share of the first step
    t0 = time.perf_counter()
    default_stream(n_streams=256, seed=0, device=device).permutation(
        t["global_batch"])
    t_stream = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_launches(chaotic_ann)
    res = train(cfg, global_batch=t["global_batch"], seq_len=t["seq_len"],
                num_microbatches=t["num_microbatches"], steps=t["steps"],
                compress_grads=True, chaotic_shuffle=True, log_every=1,
                device=device, log_fn=lambda s: None)
    launches = read_launches(chaotic_ann)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    what = f"lm train llama3_2_3b ({t['layers']} layers, bf16, remat)"
    others = {k: v for k, v in launches.items()
              if v and k != "chaotic_ann_bits"}
    check(launches["chaotic_ann_bits"] > 0,
          f"{what}: the chaotic shuffle launched no K1")
    check(not others, f"{what}: kernels other than K1 launched: {others}")
    hist = res.metrics_history
    check(len(hist) == t["steps"] and res.final_state.step == t["steps"],
          f"{what}: {len(hist)} steps logged, state at {res.final_state.step}")
    for m in hist:
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"{what}: step {m['step']} loss {m['loss']} grad norm "
              f"{m['grad_norm']}")
    tokens = t["global_batch"] * t["seq_len"]
    step_s = float(np.median([m["step_time_s"] for m in hist[1:]]))
    flops = 6 * cfg.n_active_params() * tokens
    tflops = flops / step_s / 1e12
    print(f"{what}: batch {t['global_batch']} x {t['seq_len']}, "
          f"{t['num_microbatches']} microbatches, int8 compression, chaotic "
          f"shuffle; {cfg.n_params() / 1e9:.3f} B params; loss "
          + ", ".join(f"{m['loss']:.4f}" for m in hist) + "; grad norm "
          + ", ".join(f"{m['grad_norm']:.4f}" for m in hist)
          + "; step ms " + ", ".join(f"{m['step_time_s'] * 1e3:.1f}"
                                     for m in hist)
          + f" (a fresh shuffle stream's first permutation alone "
          f"{t_stream * 1e3:.1f} ms; median of steps 1-{t['steps'] - 1}: "
          f"{step_s * 1e3:.1f} ms, "
          f"{tokens / step_s:.0f} tokens/s); model TFLOP/s "
          f"6 x {cfg.n_active_params()} active params x {tokens} tokens / "
          f"step s = {tflops:.1f}, {tflops * 1e12 / H100_BF16_DENSE_FLOPS:.1%} "
          f"of the bf16 dense peak {H100_BF16_DENSE_FLOPS / 1e12:.0f}; K1 "
          f"launches {launches['chaotic_ann_bits']}; peak {peak:.2f} GiB; "
          f"card {card}")
    del res
    torch.cuda.empty_cache()
    return launches["chaotic_ann_bits"]


def phase_lm(torch, device, card) -> int:
    """Phase 16: the LM stack on the card.  Returns K1's launches in the
    training run."""
    t0 = time.perf_counter()
    for arch, n_layers in LM_SERVE:
        lm_serve(torch, device, card, arch, n_layers)
    lm_card_vs_cpu(torch, device, card)
    n = lm_train(torch, device, card)
    print(f"lm phase: {time.perf_counter() - t0:.1f} s; card {card}")
    return n


def run_phases(torch, device, card, log, sass, wide_build) -> int:
    """Phases 2-17 (the module's docstring), the SASS counts, then the
    ``kernels`` and ``ok`` lines; ``wide_build`` is phase 17's build,
    running since before phase 2."""
    neg0 = torch.relu(torch.tensor([-0.0], device=device))
    print(f"torch.relu(-0.0) on the card: signbit={bool(neg0.signbit())}")

    errs = {}
    t_start = t_phase = time.perf_counter()

    def phase_done(what):
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase {what}: {now - t_phase:.1f} s")
        t_phase = now

    phase_kernels(torch, device, errs)
    phase_done("kernel checks")
    phase_bf16x2(torch, device, log, errs)
    phase_done("bf16x2 checks")
    phase_gang_kernels(torch, device, errs)
    phase_mxu_gang_kernels(torch, device, errs)
    phase_done("gang kernel checks")
    phase_lattice_gang_kernels(torch, device, errs)
    phase_done("lattice gang kernel checks")
    rows, served = [], {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        launches, t, served[tag] = phase_served(
            torch, device, dtype, tag, card, "chen", WORDS_PER_CLIENT, 1000,
            errs)
        rows += kernel_rows("chen", "vpu", tag, launches, t, errs)
    phase_done("served path")
    phase_nist(torch, device, served)
    phase_done("nist")
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        path, t = phase_farm(torch, device, dtype, tag, card)
        for name, key in (("chaotic_ann_gang_bits", "k3_f2"),
                          ("chaotic_ann_gang_stacked", "k4_f1")):
            check(path[name] > 0, f"{name} not launched on the {tag} farm path")
            rows.append({
                "name": f"{name}/{tag}", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/chaotic_ann.cu",
                "replaces": REPLACES[name], "path": "farm",
                "launches": path[name], "max_abs_err": errs[(name, tag)],
                "ms": t[key], "plain_ms": t[f"{key}_plain"],
                "bound_ms": t[f"{key}_bound"][0],
                "bound_by": t[f"{key}_bound"][1], "library_ms": None,
                "shape": "F2 ragged" if key == "k3_f2" else "F1 padded",
            })
            if key == "k3_f2":
                rows[-1].update(ms_f1_padded=t["k3_f1"],
                                bound_ms_f1_padded=t["k3_f1_bound"][0],
                                f2_hot_rows=t["rows_f2"])
            rows[-1]["kernel"] = (BF16X2_GANG_KERNELS if tag == "bf16"
                                  else F32_GANG_KERNELS)[name]
    phase_done("farm path")
    tier = phase_serving_tier(torch, device, card)
    phase_done("serving tier")
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        launches, t, words = phase_served(
            torch, device, dtype, tag, card, LATTICE, LATTICE_WORDS, 2000,
            errs)
        rows += kernel_rows(LATTICE, "vpu", tag, launches, t, errs)
        p, failed = nist3(words)
        print(f"nist {LATTICE} {tag} on {words.size} served words: "
              + ", ".join(f"{k} p={v:.4g}" for k, v in p.items())
              + f"; under alpha {NIST_ALPHA}: {failed} (not gated)")
    phase_done("lattice path")
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        launches, t, words = phase_served(
            torch, device, dtype, tag, card, LATTICE, MXU_WORDS, 3000, errs,
            unit="mxu")
        rows += kernel_rows(LATTICE, "mxu", tag, launches, t, errs)
        p, failed = nist3(words)
        print(f"nist {LATTICE} mxu {tag} on {words.size} served words: "
              + ", ".join(f"{k} p={v:.4g}" for k, v in p.items())
              + f"; under alpha {NIST_ALPHA}: {failed} (not gated)")
    phase_done("mxu path")
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        path, t = phase_lattice_farm(torch, device, dtype, tag, card, errs)
        for name, key, shape in (
                ("chaotic_ann_lattice_gang_bits", "k3", "F3 padded concat"),
                ("chaotic_ann_lattice_gang_stacked", "k4", "F1 padded")):
            rows.append({
                "name": f"{name}/{tag}", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/chaotic_ann.cu",
                "replaces": REPLACES[name], "path": "lattice-farm",
                "launches": path[name], "max_abs_err": errs[(name, tag)],
                "ms": t[key], "plain_ms": t[f"{key}_plain"],
                "bound_ms": t[f"{key}_bound"][0],
                "bound_by": t[f"{key}_bound"][1], "library_ms": None,
                "shape": shape,
                "form": (f"{LATTICE} vpu lattice (K5, "
                         f"src/repro/kernels/chaotic_ann.py:61)"),
            })
            if tag == "bf16":
                rows[-1]["kernel"] = BF16X2_LATTICE_KERNELS[name]
    phase_done("lattice farm path")
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        path, t = phase_mxu_farm(torch, device, dtype, tag, card, errs)
        name = "chaotic_ann_mxu_gang_bits"
        check(path[name] > 0, f"{name} not launched on the {tag} mxu farm "
                              f"path")
        rows.append({
            "name": f"{name}/{tag}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chaotic_ann.cu",
            "replaces": REPLACES[name], "path": "mxu-farm",
            "launches": path[name], "max_abs_err": errs[(name, tag)],
            "ms": t["k3"], "plain_ms": t["k3_plain"],
            "plain_lanes": t["plain_lanes"],
            "bound_ms": t["k3_bound"][0], "bound_by": t["k3_bound"][1],
            "library_ms": None, "shape": "F3 padded concat",
            "ms_f1": t["k3_f1"], "bound_ms_f1": t["k3_f1_bound"][0],
            "gang_false_ms_f1": t["k1_x4_f1"],
            "scalar_ms_f1": t["k3_scalar_f1"],
            "scalar_gang_false_ms_f1": t["k1_x4_scalar_f1"],
            "kernel": MXU_K3_KERNELS[tag],
            "flush_wall_ms": {k: v * 1e3 for k, v in t["walls"].items()},
            "form": (f"{LATTICE} mxu unit (the dot form, "
                     f"src/repro/kernels/chaotic_ann.py:154-161, with the "
                     f"shared coupling dot :664-667)"),
        })
    phase_done("mxu farm path")
    phase_activation_hook(torch, device)
    phase_done("activation check")
    launches, times, chen_nets, chen_ds = phase_paper_flow(torch, device,
                                                           card, errs)
    for (name, act, tag), n in sorted(launches.items()):
        key = "bits" if name == "chaotic_ann_bits" else "traj"
        t = times[(act, tag)]
        rows.append({
            "name": f"{name}/{act}/{tag}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chaotic_ann.cu",
            "replaces": REPLACES[name], "path": "paper-flow",
            "launches": n, "max_abs_err": errs[(name, act, tag)],
            "ms": t[f"{key}_ms"], "plain_ms": t[f"{key}_plain_ms"],
            "bound_ms": t[f"{key}_bound"][0],
            "bound_by": t[f"{key}_bound"][1], "library_ms": None,
            "ops_step": t["ops_step"],
            "relu_ms": t["relu_bits_ms"] if key == "bits" else None,
            "form": (f"vpu scalar, {act} (_activation, "
                     f"src/repro/kernels/chaotic_ann.py:44-45)"),
        })
        if key == "traj" and tag == "bf16":
            rows[-1]["kernel"] = K2_X2_KERNELS[("vpu", tag)]
    phase_done("paper flow")
    gen_rows, gen_nets = phase_generated_farm(torch, device, card, chen_nets,
                                              errs)
    rows += gen_rows
    phase_done("generated farm")
    rows += phase_lattice_activations(torch, device, card, gen_nets, errs)
    phase_done("lattice activations")
    rows += phase_mxu_activations(torch, device, card, gen_nets, errs)
    phase_done("mxu activations")
    rows += phase_shapes(torch, device, card, errs, chen_ds)
    phase_done("shapes")
    sharded = phase_sharded(torch, device, card)
    phase_done("sharded")
    lm_k1 = phase_lm(torch, device, card)
    phase_done("lm")
    rows += phase_wide(torch, device, card, errs, chen_nets, wide_build)
    phase_done("wide")
    for row in rows:
        if row["name"] == "chaotic_ann_bits/f32" and row["path"] == "served":
            row["lm_launches"] = lm_k1
    for row in rows:
        n = sharded.get(tuple(row["name"].split("/")))
        if n is not None and row["path"] in ("served", "farm",
                                             "lattice-farm", "mxu-farm"):
            row["sharded_launches"] = n
    # the serving tier's launches, beside each kernel's own path's
    for row in rows:
        n = tier.get(tuple(row["name"].split("/")))
        if n is not None and row["path"] in ("served", "unfused", "farm"):
            row["serving_tier_launches"] = n
    print(f"phases in all: {time.perf_counter() - t_start:.1f} s (after the "
          f"build)")
    t0 = time.perf_counter()
    report, loops = sass_counts(sass)
    print(f"sass (waited {time.perf_counter() - t0:.1f} s): {report}")
    fill_chain_floors(rows, loops)
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
