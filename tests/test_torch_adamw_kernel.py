"""AdamW's update as one hand-written CUDA launch (``kernels/adamw.py``,
``csrc/adamw.cu``) and its plain version, the eager loop
(``kernels/ref.adamw_update``).

On the CPU: the plain version gives the bits of the loop that
``train/optimizer.apply_updates`` ran before the kernel (kept here
verbatim as the oracle) on h2o-danube-1.8b's and granite-moe-3b-a800m's
parameters, in float32 and bfloat16, with decay on and off, for three
steps; the chunk plan gives every element one chunk; CPU tensors take the
loop; the op count takes the update's bytes in each type. On the card
(``cuda``): the kernel is ``torch.equal`` to the loop, also at chunks of
8 elements over odd, empty and unaligned sizes. The file imports
neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_adamw_kernel.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import adamw, ref  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

ARCHS = ["h2o-danube-1.8b", "granite-moe-3b-a800m"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CFG = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
# sizes around the kernel's 8-element vectors and its chunks
ODD = [(), (1,), (7,), (9,), (0,), (31,), (adamw.CHUNK + 1,), (3, 5, 7)]


@pytest.fixture(autouse=True)
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@torch.no_grad()
def parent_apply_updates(cfg, params, grads, state, decay=None, split=None):
    """``optimizer.apply_updates`` before the kernel, verbatim."""
    _f32 = opt._f32
    step = state.step + 1
    gn = opt.global_norm(grads, split)
    dev = gn.device
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    lr = opt.schedule(cfg, step)
    # the step's scalars, float32, on the gradients' device once
    lr_d, b1c, b2c = (t.to(dev) for t in (
        lr, 1 - _f32(cfg.b1) ** step, 1 - _f32(cfg.b2) ** step))
    for n, p in params.items():
        g = grads[n].float() * scale
        m, v = state.m[n], state.v[n]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if (p.dim() >= 2) if decay is None else decay[n]:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr_d * delta).to(p.dtype))
        del g, delta
    return params, opt.OptState(step, state.m, state.v), \
        {"grad_norm": gn, "lr": lr}


def shapes(cfg, mesh=None):
    """(name, shape) of each parameter of a trainable model of ``cfg``
    (on ``meta``; with ``mesh``, one rank's slices), and its decay mask."""
    model = tf.init_model(cfg, None, "meta", trainable=True, mesh=mesh)
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()], \
        model.decay_mask()


def cases(arch, full=False):
    """The parameter shapes of ``arch`` cut to 2 layers: the smoke
    config's, with the published config's of at most 2^21 elements
    (norm scales, routers, kv projections) and the odd sizes; with
    ``full`` the published config's, all of them."""
    got, mask = shapes(get_smoke_config(arch).scaled(num_layers=2))
    pub, pmask = shapes(get_config(arch).scaled(num_layers=2))
    if full:
        return pub, pmask
    got += [("full." + n, s) for n, s in pub if math.prod(s) <= 1 << 21]
    mask.update({"full." + n: pmask[n] for n, _ in pub})
    got += [(f"odd.{i}", s) for i, s in enumerate(ODD)]
    mask.update({f"odd.{i}": len(s) >= 2 for i, s in enumerate(ODD)})
    return got, mask


def draw(named, dtype, device, seed, scale=1.0):
    """A random tensor of each shape, in ``dtype`` on ``device`` (drawn
    there, float32, from ``seed``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {n: (scale * torch.randn(s, generator=gen, device=device)).to(
        dtype) for n, s in named}


def three_steps(update, named, mask, dtype, device, decay, seed=0,
                grads_of=None):
    """Params, m and v after three steps of ``update`` (an
    ``apply_updates``) from the same draws: gradients of norm far above
    the clip in the first two steps (clipped), under it in the third."""
    params = draw(named, dtype, device, seed)
    state = opt.init_opt_state(params)
    flags = mask if decay else {n: False for n in mask}
    for i, g_scale in enumerate((10.0, 1.0, 1e-4)):
        grads = grads_of(i) if grads_of else \
            draw(named, dtype, device, seed + 1 + i, g_scale)
        params, state, _ = update(CFG, params, grads, state, decay=flags)
    return params, state


def assert_same(a, b):
    (pa, sa), (pb, sb) = a, b
    assert sa.step == sb.step == 3
    for n in pa:
        assert torch.equal(pa[n], pb[n]), ("p", n)
        assert torch.equal(sa.m[n], sb.m[n]), ("m", n)
        assert torch.equal(sa.v[n], sb.v[n]), ("v", n)


# -- CPU -----------------------------------------------------------------------

@pytest.mark.parametrize("decay", [True, False], ids=["decay", "no_decay"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_update_is_the_parents_loop(arch, dtype, decay):
    named, mask = cases(arch)
    got = three_steps(opt.apply_updates, named, mask, DTYPES[dtype], "cpu",
                      decay)
    want = three_steps(parent_apply_updates, named, mask, DTYPES[dtype],
                       "cpu", decay)
    assert_same(got, want)


@pytest.mark.parametrize("chunk", [8, 16, adamw.CHUNK])
def test_the_plan_gives_every_element_one_chunk(chunk):
    """The chunks are numbered tensor by tensor: each tensor's run of
    chunks starts where the previous one's ends and tiles its elements,
    and every chunk number belongs to the last tensor whose first chunk
    is at or below it (the rule the kernel walks by), which is never an
    empty one."""
    numels = [0, 1, 7, 8, 9, 0, chunk - 1, chunk, chunk + 1, 3 * chunk + 5,
              0, 1]
    first, chunks = adamw.plan(numels, chunk)
    per = [-(-n // chunk) for n in numels]
    assert chunks == sum(per) and first[0] == 0
    assert all(first[t + 1] == first[t] + per[t]
               for t in range(len(numels) - 1))
    for t, n in enumerate(numels):
        got = np.zeros(n, np.int64)
        for c in range(first[t], first[t] + per[t]):
            lo = (c - first[t]) * chunk
            got[lo:min(lo + chunk, n)] += 1
        assert (got == 1).all(), t
    for c in range(chunks):
        t = max(i for i in range(len(numels)) if first[i] <= c)
        assert numels[t] and c < first[t] + per[t], c


def test_cpu_tensors_take_the_loop(monkeypatch):
    """On the CPU ``apply_updates`` runs the plain loop once a step, and
    the kernel's route launches nothing and updates no element there."""
    calls = []
    loop = ref.adamw_update
    monkeypatch.setattr(ref, "adamw_update",
                        lambda *a: calls.append(1) or loop(*a))
    launches = adamw.adamw_update.launches
    p = {"w": torch.ones(3, 4), "b": torch.ones(5)}
    g = {k: torch.full_like(t, 0.5) for k, t in p.items()}
    state = opt.init_opt_state(p)
    adamw.adamw_update(
        list(p.values()), list(g.values()), list(state.m.values()),
        list(state.v.values()), [True, False], torch.tensor(1.0),
        opt.schedule(CFG, 1), 1 - opt._f32(CFG.b1), 1 - opt._f32(CFG.b2),
        CFG.b1, CFG.b2, CFG.eps, CFG.weight_decay)
    assert len(calls) == 1
    opt.apply_updates(CFG, p, g, state)
    assert len(calls) == 2 and float(p["w"][0, 0]) < 1.0
    assert adamw.adamw_update.launches == launches


def test_meta_counts_and_checks_as_the_card_would(monkeypatch):
    """On ``meta`` (the dry run) the inputs are checked as the card's,
    the kernel's cost is counted and nothing runs: inputs the kernel does
    not take are refused."""
    p = [torch.empty(4, 6, device="meta"), torch.empty(7, device="meta")]
    m = [torch.empty(t.shape, device="meta") for t in p]
    scale = torch.empty((), device="meta")
    host = [opt.schedule(CFG, 1), torch.tensor(0.1), torch.tensor(0.05)]
    args = ([True, False], scale, *host, 0.9, 0.95, 1e-8, 0.1)
    # a view of a larger weight is taken as well
    p[0] = torch.empty(4, 12, device="meta")[:, :6]
    calls = []
    monkeypatch.setattr(ref, "adamw_update", lambda *a: calls.append(1))
    launches = adamw.adamw_update.launches
    with op_analysis.count("meta") as counter:
        adamw.adamw_update(p, [t.clone() for t in m], m, m, *args)
    assert counter.kernels["adamw"]["flops"] == 17 * 24 + 15 * 7
    assert counter.kernels["adamw"]["bytes"] == 28 * 31
    assert not calls and adamw.adamw_update.launches == launches
    with pytest.raises(TypeError):             # a gradient of another type
        adamw.adamw_update(p, [t.bfloat16() for t in m], m, m, *args)
    with pytest.raises(TypeError):             # bf16 moments
        adamw.adamw_update(p, m, [t.bfloat16() for t in m], m, *args)
    with pytest.raises(ValueError):            # a moment of another shape
        adamw.adamw_update(p, m, [m[0], m[0]], m, *args)


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_cost_is_one_pass_in_the_parameters_type(dtype):
    """The op count takes p, g, m and v read once and p, m and v written
    once: 28 bytes an element with float32 parameters, 22 with bfloat16;
    17 operations where the parameter decays and 15 where it does not."""
    dt = DTYPES[dtype]
    p = [torch.empty(5, 3, dtype=dt), torch.empty(0, dtype=dt),
         torch.empty(11, dtype=dt)]
    flops, nbytes = adamw.cost(p, [True, True, False])
    assert flops == 17 * 15 + 15 * 11
    assert nbytes == {"float32": 28, "bfloat16": 22}[dtype] * 26


# -- the card ------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("decay", [True, False], ids=["decay", "no_decay"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_is_the_loop_on_the_models_shapes(cuda, arch, dtype, decay):
    """Three steps over the published config's parameters cut to 2 layers
    (and the odd sizes): p, m and v bit for bit the loop's, one launch a
    step."""
    named, mask = cases(arch, full=True)
    named += [(f"odd.{i}", s) for i, s in enumerate(ODD)]
    mask.update({f"odd.{i}": len(s) >= 2 for i, s in enumerate(ODD)})
    launches = adamw.adamw_update.launches
    got = three_steps(opt.apply_updates, named, mask, DTYPES[dtype], cuda,
                      decay)
    assert adamw.adamw_update.launches == launches + 3
    want = three_steps(parent_apply_updates, named, mask, DTYPES[dtype],
                       cuda, decay)
    assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_is_the_loop_on_an_fsdp_slice(cuda, arch):
    """One rank's slices of 2 data ranks (FSDP over "data")."""
    cfg = get_config(arch).scaled(num_layers=2)
    named, mask = shapes(cfg, Mesh((), ("data", "model"),
                                   {"data": 2, "model": 1}))
    assert_same(three_steps(opt.apply_updates, named, mask, torch.float32,
                            cuda, True),
                three_steps(parent_apply_updates, named, mask, torch.float32,
                            cuda, True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_is_the_loop_at_the_edges(cuda, dtype, monkeypatch):
    """A parameter the loss does not reach (zero gradient), gradients near
    eps and below (F8: 1e-7 to 1e-12, subnormal squares, zeros), tensors
    not 16-byte aligned and views of larger weights, and the same bits
    at another chunk size."""
    dt = DTYPES[dtype]
    named = [("zero", (1000,)), ("tiny", (4099,)), ("w", (64, 96)),
             ("b", (33,))]
    mask = {"zero": True, "tiny": True, "w": True, "b": False}
    rng = np.random.default_rng(5)

    def grads_of(i):
        tiny = rng.choice([1e-7, 3e-8, 1e-8, -1e-8, 5e-9, 1e-10, 1e-12, 0.0],
                          4099) * (1 + rng.random(4099))
        base = torch.zeros(64 * 96 + 1, dtype=dt, device=cuda)
        w = base[1:].view(64, 96)                  # 4 bytes off alignment
        w.copy_(torch.from_numpy(rng.standard_normal((64, 96)) * 1e-6))
        return {"zero": torch.zeros(1000, dtype=dt, device=cuda),
                "tiny": torch.from_numpy(tiny.astype(np.float32)).to(
                    cuda, dt),
                "w": w, "b": torch.full((33,), 1e-9, dtype=dt, device=cuda)}

    def run(update):
        return three_steps(update, named, mask, dt, cuda, True, seed=9,
                           grads_of=grads_of)
    want = run(parent_apply_updates)
    rng = np.random.default_rng(5)
    assert_same(run(opt.apply_updates), want)
    rng = np.random.default_rng(5)
    monkeypatch.setattr(adamw, "CHUNK", 8)
    assert_same(run(opt.apply_updates), want)

    # views: a parameter that is a slice of a larger weight, its moments
    # slices too, updated through contiguous copies
    def sliced(update):
        whole = draw([("p", (16, 40))], dt, cuda, 2)["p"]
        p = {"p": whole[:, 4:36]}
        g = {"p": draw([("g", (16, 32))], dt, cuda, 3)["g"]}
        state = opt.init_opt_state({"p": p["p"].contiguous()})
        for _ in range(3):
            update(CFG, p, g, state)
        return whole, state
    a, b = sliced(opt.apply_updates), sliced(parent_apply_updates)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1].m["p"], b[1].m["p"])
