"""The f32 scalar gang kernels on the f32 row loop (``f32_gang_bits_kernel``,
K3, and ``f32_gang_stacked_kernel``, K4, in ``csrc/chaotic_ann.cu``)
mirrored on the CPU.

Both run ``f32_rows``, the f32 K1's row loop, a thread a lane.  Each sum
starts from its first term and adds a bias whose -0 is +0 (exact: the
kernels' source says why).  K3 indexes its CTAs of 128 threads and lanes
by (lane block, CTA within the block) (``GangCta<1, 128, 1>``), K4 by
(CTA, core), its lanes counted inside the core; a thread past its block's
or core's end returns.  Here:

* the launchers' maps: every lane computed and written by exactly one
  thread, every CTA inside one block or core;
* a plain mirror of the row loop, in the kernels' op order (sums from
  their first term, output sums in j order), bitwise
  ``ref.chaotic_ann_gang_bits_ref`` and ``ref.chaotic_ann_gang_stacked_ref``
  in f32 for relu, tanh and sigmoid at 3-8 (the four committed farm nets)
  and 4-16 (hyperlorenz's farm and registry nets), with a row map of 0,
  partial and full blocks and a frozen K4 core;
* the mirror against the JAX package's ``chaotic_ann_gang_bits_pallas`` /
  ``chaotic_ann_gang_stacked_pallas`` in interpret mode, at the f32 tiers
  of ``tests/test_torch_gang_activation.py`` (XLA's CPU code and PyTorch's
  eager ops differ in the low bits, so f32 words are not compared across
  the two): one word row from the JAX state within ``F32_ONE_STEP``, 16
  free-running steps with ragged rows within ``F32_FREE_RUN``.

Inside the port every comparison is bitwise: the tolerance is 0.  The
card holds the kernels to the plain versions (``tests/test_torch_gpu.py``,
``chip_smoke.py``), and the kernels' quotients (``div_fast``) and exp to
the IEEE forms the plain version computes, on every f32 input.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chaotic_ann as jax_ann
from repro_torch.kernels import chaotic_ann, ops, ref
from repro_torch.prng.stream import default_params

from test_torch_kernels import F32_FREE_RUN, F32_ONE_STEP

KEYS = ("w1", "b1", "w2", "b2")
CTA = 128                                 # kThreads of chaotic_ann.cu
FARM = (pathlib.Path(__file__).resolve().parents[1] / "results"
        / "generated_cores" / "farm")
GANGS = {"3-8": ("chen", "chua", "lorenz", "rossler"),
         "4-16": ("hyperlorenz", "registry:hyperlorenz")}
N_STEPS = 16                              # 8 word rows
CORE_MAP = np.array([2, 0, 3, 1, 1, 2])   # modulo the gang's cores
K3_ROWS = np.array([0, 3, 8, 1, 8, 5])    # 0, partial and full blocks
K4_ROWS = np.array([3, 0, 8, 5])          # the gang's first cores: a frozen
K4_LANES = 64 + 37                        # one; a ragged last CTA


# ---------------------------------------------------------------------------
# The launchers' maps (launch_gang_bits / _stacked, a thread a lane)
# ---------------------------------------------------------------------------

def k3_map(n_lanes: int, s_block: int) -> dict:
    """Every thread of an f32 K3 launch, as ``launch_gang_bits``'s grid and
    ``GangCta<1, 128, 1>`` compute them: its CTA, thread, lane block, lane
    and liveness (a thread past its block's end returns)."""
    n_blocks = -(-n_lanes // s_block)
    per_block = -(-s_block // CTA)
    t = np.arange(n_blocks * (s_block // CTA) * CTA)
    cta, tid = t // CTA, t % CTA
    block = cta // per_block
    first = block * s_block
    slot = (cta % per_block) * CTA + tid
    return dict(cta=cta, tid=tid, block=block, lane=first + slot,
                live=slot < np.minimum(s_block, n_lanes - first))


def k4_map(n_cores: int, n_lanes: int) -> dict:
    """Every thread of an f32 K4 launch (grid (ceil(n_lanes / 128), C)):
    lanes counted inside the thread's core ``block``, as elements
    ``core * n_lanes + lane`` of the pooled operands."""
    grid_x = -(-n_lanes // CTA)
    t = np.arange(n_cores * grid_x * CTA)
    cta, tid = t // CTA, t % CTA
    core, cx = cta // grid_x, cta % grid_x
    slot = cx * CTA + tid
    return dict(cta=cta, tid=tid, block=core, live=slot < n_lanes,
                lane=core * n_lanes + slot)


def check_map(m: dict, n_lanes: int, lane_block):
    """Each lane written by exactly one live thread, in its own block or
    core; one block a CTA."""
    live = m["live"]
    assert np.array_equal(np.sort(m["lane"][live]), np.arange(n_lanes))
    assert np.array_equal(lane_block(m["lane"][live]), m["block"][live])
    per_cta = m["block"].reshape(-1, CTA)
    assert (per_cta == per_cta[:, :1]).all()


@pytest.mark.parametrize("s_block", [128, 256, 384])
def test_k3_map(s_block):
    """K3's CTAs of 128 lanes fill every s_block (a multiple of 128) whole:
    no dead thread; a lane's thread runs its own block's core and rows, 0
    rows included."""
    n_lanes = 5 * s_block
    m = k3_map(n_lanes, s_block)
    check_map(m, n_lanes, lambda lane: lane // s_block)
    assert m["live"].all()
    assert m["cta"].max() + 1 == n_lanes // CTA


@pytest.mark.parametrize("n_lanes", [1, 5, 37, 64, 257])
def test_k4_map(n_lanes):
    """K4 per core: a ragged edge's threads lie past the core's lanes and
    return, each CTA inside its core."""
    n_cores = 3
    m = k4_map(n_cores, n_lanes)
    check_map(m, n_cores * n_lanes, lambda lane: lane // n_lanes)
    assert (~m["live"]).sum() == n_cores * (-(-n_lanes // CTA) * CTA - n_lanes)


# ---------------------------------------------------------------------------
# The mirror of the row loop
# ---------------------------------------------------------------------------

def gang_weights(shape: str):
    """The stacked f32 numpy weights of one of GANGS."""
    per_core = []
    for name in GANGS[shape]:
        if name.startswith("registry:"):
            p = default_params(system=name.split(":")[1])
        else:
            with np.load(FARM / name / "weights.npz") as npz:
                p = dict(npz)
        per_core.append([np.asarray(p[k], np.float32) for k in KEYS])
    return [np.stack(ws) for ws in zip(*per_core)]


def f32_step(w, x: torch.Tensor, act: str) -> torch.Tensor:
    """``f32_step`` of every lane at once: ``w`` each lane's core's
    (w1 (P, I, H), b1 (P, H), w2 (P, H, I), b2 (P, I)), biases -0 as +0;
    x (P, I)."""
    w1, b1, w2, b2 = w
    h = w1[:, 0] * x[:, 0:1]
    for i in range(1, x.shape[1]):
        h = h + w1[:, i] * x[:, i:i + 1]
    h = ref.ACTIVATIONS[act](h + b1)
    y = w2[:, 0] * h[:, 0:1]
    for j in range(1, h.shape[1]):
        y = y + w2[:, j] * h[:, j:j + 1]
    return y + b2


def fold(x: torch.Tensor) -> torch.Tensor:
    lo = x.view(torch.int32).to(torch.int64) & 0xFFFF
    f = lo[:, 0]
    for i in range(1, x.shape[1]):
        f = f ^ (lo[:, i] << (5 * i % 16))
    return f


def mirror_gang(w_np, m: dict, x0, offsets, block_core, block_rows,
                n_steps: int, act: str):
    """A gang launch of the f32 kernels over the map ``m`` (``k3_map``,
    or ``k4_map`` on the pooled lanes): every live thread runs its block's
    or core's core for its rows of (step, fold, step, fold), counter and
    finalizer, and writes its lane.  ``x0`` (S, I) and ``offsets`` (S,)
    pooled.  Returns (n_steps // 2, S) int64 words, zero past a lane's
    rows, and the (S, I) state."""
    n_lanes = x0.shape[0]
    live = torch.from_numpy(m["live"])
    lane = torch.from_numpy(m["lane"])[live]
    block = torch.from_numpy(m["block"])[live]
    cores = torch.as_tensor(np.asarray(block_core))[block]
    w = [torch.from_numpy(a)[cores] for a in w_np]
    w[1], w[3] = w[1] + 0.0, w[3] + 0.0                  # -0 as +0
    rows = torch.as_tensor(np.asarray(block_rows))[block]
    x = x0[lane].clone()
    words = torch.zeros((n_steps // 2, n_lanes), dtype=torch.int64)
    for r in range(n_steps // 2):
        nx = f32_step(w, x, act)
        hi = fold(nx)
        nx = f32_step(w, nx, act)
        lo = fold(nx)
        run = rows > r
        x = torch.where(run[:, None], nx, x)
        ctr = (offsets[lane] + r) & ops._M32
        out = ops._finalize_words((((hi << 16) & ops._M32) | lo)
                                  ^ ops._mul32(ctr, 0x9E3779B9))
        words[r, lane[run]] = out[run]
    state = torch.zeros_like(x0)
    state[lane] = x
    return words, state


def inputs(rng, shape):
    x0 = torch.from_numpy(rng.uniform(-0.9, 0.9, shape).astype(np.float32))
    off = rng.integers(0, 1 << 32, shape[:-1], dtype=np.int64)
    off[..., :2] = [0xFFFFFFFF, 0xFFFFFFFE]       # the counter wraps mid-run
    return x0, torch.from_numpy(off)


def k3_case(shape: str, s_block: int, seed: int):
    w = gang_weights(shape)
    core_map = CORE_MAP % len(GANGS[shape])
    x0, off = inputs(np.random.default_rng(seed),
                     (len(core_map) * s_block, w[0].shape[1]))
    return w, core_map, x0, off


def k4_case(shape: str, seed: int):
    w = gang_weights(shape)
    n_cores = len(GANGS[shape])
    x0, off = inputs(np.random.default_rng(seed),
                     (n_cores, K4_LANES, w[0].shape[1]))
    return w, K4_ROWS[:n_cores], x0, off


def mirror_k3(w, core_map, x0, off, s_block, act, rows=K3_ROWS,
              n_steps=N_STEPS):
    m = k3_map(x0.shape[0], s_block)
    return mirror_gang(w, m, x0, off, core_map, rows, n_steps, act)


def mirror_k4(w, rows, x0, off, act, n_steps=N_STEPS):
    n_cores, n_lanes = x0.shape[:2]
    m = k4_map(n_cores, n_lanes)
    words, state = mirror_gang(w, m, x0.reshape(n_cores * n_lanes, -1),
                               off.reshape(-1), range(n_cores), rows,
                               n_steps, act)
    return words.reshape(-1, n_cores, n_lanes), state.reshape(x0.shape)


def bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int32).numpy()


@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("shape", ["3-8", "4-16"])
def test_mirror_k3_is_the_plain_k3(shape, act):
    """The mirror of K3 at s_block 128 (the served farms')
    and 256, bitwise ``ref.chaotic_ann_gang_bits_ref`` and the wrapper on
    the CPU (the plain version): every word (zero past a block's rows) and
    the final state."""
    for s_block in (128, 256):
        w, core_map, x0, off = k3_case(shape, s_block, s_block)
        tw = [torch.from_numpy(a) for a in w]
        words_p, state_p = ref.chaotic_ann_gang_bits_ref(
            *tw, x0, core_map, N_STEPS, off, K3_ROWS, act)
        _, state_w = chaotic_ann.chaotic_ann_gang_bits(
            *tw, x0, core_map, off, K3_ROWS, n_steps=N_STEPS,
            s_block=s_block, t_block=4, unroll=1, activation=act)
        np.testing.assert_array_equal(bits(state_w), bits(state_p))
        words, state = mirror_k3(w, core_map, x0, off, s_block, act)
        assert torch.equal(words, ops.from_uint32(words_p))
        np.testing.assert_array_equal(bits(state), bits(state_p))
        # 0-row block 0 keeps x0; its words stay unwritten
        np.testing.assert_array_equal(bits(state[:s_block]),
                                      bits(x0[:s_block]))
        assert not words[:, :s_block].any()


@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("shape", ["3-8", "4-16"])
def test_mirror_k4_is_the_plain_k4(shape, act):
    """The mirror of K4 on the gang's cores of 101 lanes (a ragged last
    CTA whose threads past the core's lanes return), a frozen core among
    them, bitwise ``ref.chaotic_ann_gang_stacked_ref``."""
    w, rows, x0, off = k4_case(shape, 3)
    words_p, state_p = ref.chaotic_ann_gang_stacked_ref(
        *(torch.from_numpy(a) for a in w), x0, N_STEPS, off, rows, act)
    words, state = mirror_k4(w, rows, x0, off, act)
    assert torch.equal(words, ops.from_uint32(words_p))
    np.testing.assert_array_equal(bits(state), bits(state_p))
    frozen = int(np.flatnonzero(rows == 0)[0])
    np.testing.assert_array_equal(bits(state[frozen]), bits(x0[frozen]))


def test_first_term_sums_keep_the_sign_of_zero():
    """The rewrite's one difference, a sum of -0 terms that starts from
    -0 where the reference's starts from +0, vanishes at the bias add with
    the bias's -0 as +0, for every sign of the terms and the bias."""
    z = torch.tensor([0.0, -0.0])
    for t0 in z:
        for t1 in z:
            for b in z:
                want = (torch.tensor(0.0) + t0 + t1) + b
                got = (t0 + t1) + (b + 0.0)
                assert bits(got.reshape(1)) == bits(want.reshape(1))


# each kernel with each activation, and each shape, at least once
@pytest.mark.parametrize("kernel,shape,act", [
    ("k3", "3-8", "tanh"), ("k3", "4-16", "relu"), ("k3", "3-8", "sigmoid"),
    ("k4", "4-16", "sigmoid"), ("k4", "3-8", "relu"), ("k4", "3-8", "tanh")])
def test_mirror_within_the_f32_tiers_of_the_jax_gang_kernel(kernel, shape,
                                                            act):
    """The mirror against the JAX K3 / K4 in interpret mode (t_block 4,
    unroll 1: rows exactly the map's): one word row from the JAX state
    after one row within F32_ONE_STEP, and 16 free-running steps with
    ragged rows within F32_FREE_RUN."""
    jw = None
    if kernel == "k3":
        w, core_map, x0, off = k3_case(shape, 128, 7)
        jw = list(map(jnp.asarray, w))
        kw = dict(s_block=128, t_block=4, unroll=1, activation=act,
                  interpret=True)
        _, j1 = jax_ann.chaotic_ann_gang_bits_pallas(
            *jw, jnp.asarray(x0.numpy()), jnp.asarray(core_map), n_steps=2,
            **kw)
        _, j2 = jax_ann.chaotic_ann_gang_bits_pallas(
            *jw, j1, jnp.asarray(core_map), n_steps=2, **kw)
        _, t2 = mirror_k3(w, core_map, torch.from_numpy(np.array(j1)), off,
                          128, act, rows=np.full(6, 1), n_steps=2)
        _, js = jax_ann.chaotic_ann_gang_bits_pallas(
            *jw, jnp.asarray(x0.numpy()), jnp.asarray(core_map), 0,
            jnp.asarray(K3_ROWS), n_steps=N_STEPS, **kw)
        _, ts = mirror_k3(w, core_map, x0, off, 128, act)
    else:
        w, rows, x0, off = k4_case(shape, 8)
        jw = list(map(jnp.asarray, w))
        kw = dict(s_block=128, t_block=4, unroll=1, activation=act,
                  interpret=True)
        ones = np.ones(len(rows), np.int64)
        _, j1 = jax_ann.chaotic_ann_gang_stacked_pallas(
            *jw, jnp.asarray(x0.numpy()), n_steps=2, **kw)
        _, j2 = jax_ann.chaotic_ann_gang_stacked_pallas(
            *jw, j1, n_steps=2, **kw)
        _, t2 = mirror_k4(w, ones, torch.from_numpy(np.array(j1)), off,
                          act, n_steps=2)
        _, js = jax_ann.chaotic_ann_gang_stacked_pallas(
            *jw, jnp.asarray(x0.numpy()), 0, jnp.asarray(rows),
            n_steps=N_STEPS, **kw)
        _, ts = mirror_k4(w, rows, x0, off, act)
    j2, js = np.asarray(j2), np.asarray(js)
    gap = np.abs(t2.numpy() - j2).max()
    assert gap <= F32_ONE_STEP(np.abs(j2).max()), gap
    gap = np.abs(ts.numpy() - js).max()
    assert gap <= F32_FREE_RUN(np.abs(js).max()), gap


@pytest.mark.parametrize("word_offset", [
    torch.tensor([0, 7, -1, (1 << 32) + 5, -(1 << 40) - 3]),
    torch.tensor([0, 7, -1, 5, 3], dtype=torch.int32),
    ops.to_uint32(torch.tensor([0, 7, 0xFFFFFFFF, 5, 1 << 31])),
    (1 << 32) + 9, -2])
def test_offsets_reach_the_kernels_as_int64_with_the_same_low_bits(
        word_offset):
    """The scalar K1/K3/K4 read the low 32 bits of int64 offsets: for every
    form a caller passes (int64, int32 and uint32 tensors, Python ints,
    negative and past 2**32) those bits are the word counter's offset
    ``ops.word_offsets`` gives; an int64 tensor of the launch's shape goes
    to the kernel as it is, with no device op."""
    got = chaotic_ann._offsets_i64(word_offset, 5, torch.device("cpu"))
    assert got.dtype == torch.int64 and got.is_contiguous()
    want = ops.word_offsets(word_offset, 5, torch.device("cpu"))
    assert torch.equal(got & ops._M32, want)
    if isinstance(word_offset, torch.Tensor) and \
            word_offset.dtype == torch.int64:
        assert got is word_offset
