"""Port parity: LM sharding, the sharded train step, the int8 gradient
all-reduce and sharded restore of ``repro_torch``.

* **Rules.**  The port's ``spec_for`` over its parameter tree (``layers`` a
  list of per-layer dicts) equals the reference's over its stacked tree,
  the reference's leading layer ``None`` dropped, for the five LM archs'
  smoke configs, ``tp_only`` both ways, on ``("data", "model")`` and
  ``("pod", "data", "model")`` meshes; so does ``spec_for`` over the
  optimizer state.
* **The sharded step** on (2, 4) meshes of eight repeats of the CPU, the
  reference test's inputs (``lm_batch(0, 0, 8, 32)``, accum 2): the
  parameters within the reference's 2e-3 (rtol and atol) of the port's
  single-device step and the loss within 1e-4; stricter, the first
  moments within 1e-5 of their largest magnitude and the gradient norm
  within 1e-5 relative.  The reference's own sharded test fails in every
  run of its suite, so the oracle is the port's single-device step, which
  ``test_torch_train.py`` holds to the reference.
* **compress_grads** bit-equal to the reference's under ``jax.vmap``
  (``axis_name``), which runs its ``psum``/``pmax`` in process.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import lm_common as jlm  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.configs import lm_common  # noqa: E402
from repro_torch.configs.lm_common import make_lm_train_step  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    Mesh,
    NamedSharding,
    P,
    ShardedTensor,
    compress_grads,
    compressed_psum,
    device_put,
    make_error_feedback_state,
    spec_for,
)
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw, constant  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

LM_ARCHS = sorted(REGISTRY)
PARAM_TOL = dict(rtol=2e-3, atol=2e-3)   # the reference test's
LOSS_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape, names=("data", "model")):
    return Mesh(np.array(["cpu"] * int(np.prod(shape)), dtype=object).reshape(shape), names)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def assert_specs_match(port, ref, layered=False):
    """``port`` (layers a list) against the reference's stacked specs."""
    if isinstance(port, list):
        for layer in port:
            assert_specs_match(layer, ref, layered=True)
    elif isinstance(port, dict):
        assert sorted(port) == sorted(ref)
        for k in port:
            assert_specs_match(port[k], ref[k], layered)
    else:
        want = tuple(ref)
        if layered:
            assert want[0] is None
            want = want[1:]
        assert tuple(port) == want, (port, ref)


@pytest.mark.parametrize("axes,shape", [(("data", "model"), (2, 4)),
                                        (("pod", "data", "model"), (2, 2, 2))])
@pytest.mark.parametrize("tp_only", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_spec_for_matches_reference(arch, tp_only, axes, shape):
    cfg, jcfg = REGISTRY[arch].smoke_config(), JAX_REGISTRY[arch].smoke_config()
    mesh = cpu_mesh(shape, axes)
    meta, shardings, rules = lm_common._param_specs(cfg, mesh, tp_only=tp_only)
    jrules = jlm._rules_for(jcfg, types.SimpleNamespace(axis_names=axes), tp_only=tp_only)
    jparams = jax.eval_shape(lambda k: jtfm.init_params(k, jcfg), jax.random.PRNGKey(0))
    port_specs = spec_for(rules, meta)
    assert_specs_match(port_specs, jsh.spec_for(jrules, jparams))
    assert_specs_match(jax.tree.map(lambda s: s.spec, shardings,
                                    is_leaf=lambda s: isinstance(s, NamedSharding)),
                       jsh.spec_for(jrules, jparams))
    # the optimizer state: the same paths (".mu/layers/wq", ...) and specs
    jinit, _ = jadamw(1e-3)
    jopt = jax.eval_shape(jinit, jparams)
    opt = adamw(1e-3)[0](meta)
    got, want = spec_for(rules, opt), jsh.spec_for(jrules, jopt)
    assert tuple(got.step) == tuple(want.step) == ()
    assert_specs_match(got.mu, want.mu)
    assert_specs_match(got.nu, want.nu)
    # the port lays each moment out as its parameter (see _opt_state_specs)
    osh = lm_common._opt_state_specs(shardings)
    assert osh.mu is shardings and osh.nu is shardings and tuple(osh.step.spec) == ()


@pytest.mark.parametrize("model", [1, 4, 16])
def test_use_tp_only_matches_reference(model):
    mesh = cpu_mesh((1, model))
    for arch in LM_ARCHS:
        want = jlm._use_tp_only(JAX_REGISTRY[arch].full_config(),
                                types.SimpleNamespace(shape={"model": model}))
        assert lm_common._use_tp_only(REGISTRY[arch].full_config(), mesh) == want


def test_stacked_axis_rule_is_refused():
    from repro_torch.distributed import ShardingRules

    with pytest.raises(ValueError, match="stacked layer axis"):
        spec_for(ShardingRules([(r"layers/wq$", ("data", None, None))]),
                 {"layers": [{"wq": torch.zeros((4, 4))}]})


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def test_device_put_blocks_and_gather():
    mesh = cpu_mesh((2, 4))
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    t = device_put(x, NamedSharding(mesh, P(("data", "model"), None)))
    assert isinstance(t, ShardedTensor) and t.shape == (8, 12) and t.blocks.shape == (2, 4)
    for c in np.ndindex(2, 4):  # "data" major: coordinate (d, m) holds rows part 4d + m
        assert torch.equal(t.blocks[c], x[4 * c[0] + c[1]][None])
    r = device_put(x, NamedSharding(mesh, P(None, "model")))
    assert len(r.unique_blocks()) == 4
    assert torch.equal(r.blocks[0, 1], r.blocks[1, 1])
    assert r.blocks[0, 1].data_ptr() != r.blocks[1, 1].data_ptr()  # no shared storage
    for s in (t, r):
        assert torch.equal(s.gather(), x) and np.array_equal(np.asarray(s), x.numpy())
    back = device_put(t, NamedSharding(cpu_mesh((4, 2)), P("model", "data")))
    assert torch.equal(back.gather(), x) and back.blocks[3, 1].shape == (4, 3)
    with pytest.raises(ValueError, match="does not divide"):
        device_put(torch.zeros((6, 4)), NamedSharding(mesh, P("model")))
    with pytest.raises(ValueError, match="not in the mesh"):
        NamedSharding(mesh, P("pod"))
    with pytest.raises(ValueError, match="more than one dimension"):
        NamedSharding(mesh, P("data", "data"))


def test_elastic_restore_to_different_mesh(tmp_path):
    """The reference's ``test_elastic_restore_to_different_mesh`` on the port."""
    tree = {"w": torch.arange(64.0).reshape(8, 8)}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, tree)
    for shape in [(2, 4), (4, 2)]:
        mesh = cpu_mesh(shape)
        sh = {"w": NamedSharding(mesh, P("data", "model"))}
        got, step, _ = mgr.restore_latest(tree, shardings=sh)
        assert step == 5
        np.testing.assert_array_equal(np.asarray(got["w"]), tree["w"].numpy())
        assert got["w"].sharding.mesh.devices.shape == shape
        assert got["w"].blocks[0, 0].shape == (8 // shape[0], 8 // shape[1])


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------


def ref_batch(cfg, mask=False):
    raw = lm_batch(0, 0, 8, 32, cfg.vocab_size)
    if mask:
        raw["mask"] = (np.random.default_rng(3).random((8, 32)) < 0.7).astype(np.float32)
    return {k: torch.from_numpy(v).reshape(2, 4, 32) for k, v in raw.items()}


def run_both(arch, tp_only=False, mask=False, grad_specs=None, lr=None, steps=2):
    """(single-device run, sharded run): params, opt state and metrics per step."""
    cfg = REGISTRY[arch].smoke_config()
    mesh = cpu_mesh((2, 4))
    params = tfm.init_params(cfg, 0, device="cpu")
    _, psh, rules = lm_common._param_specs(cfg, mesh, tp_only=tp_only)
    sharded = device_put(tfm.param_tree(params), psh)
    step1, init1 = make_lm_train_step(cfg, accum=2, lr=lr)
    step2, _ = make_lm_train_step(cfg, accum=2, lr=lr,
                                  grad_specs=grad_specs(rules, sharded) if grad_specs else None)
    opt1 = init1(params)
    opt2 = device_put(opt1, lm_common._opt_state_specs(psh))
    batch = ref_batch(cfg, mask)
    bsh = device_put(batch, {k: NamedSharding(mesh, P(None, "data", None)) for k in batch})
    m1s, m2s = [], []
    for _ in range(steps):
        params, opt1, m1 = step1(params, opt1, batch)
        sharded, opt2, m2 = step2(sharded, opt2, bsh)
        m1s.append(m1)
        m2s.append(m2)
    return (tfm.param_tree(params), opt1, m1s), (sharded, opt2, m2s)


def assert_sharded_step_close(single, sharded):
    (p1, o1, m1s), (p2, o2, m2s) = single, sharded
    for m1, m2 in zip(m1s, m2s):
        assert abs(float(m1["loss"]) - float(m2["loss"])) <= LOSS_TOL
        np.testing.assert_allclose(float(m2["gnorm"]), float(m1["gnorm"]), rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert isinstance(b, ShardedTensor)
        np.testing.assert_allclose(b.numpy(), a.detach().numpy(), **PARAM_TOL)
    for a, b in zip(tree_leaves(o1.mu), tree_leaves(o2.mu)):
        assert float((b.gather() - a).abs().max()) <= 1e-5 * max(float(a.abs().max()), 1e-30)
    assert int(o2.step.gather()) == int(o1.step) == len(m1s)


@pytest.mark.parametrize("arch,tp_only,mask", [("qwen2-1.5b", False, False),
                                               ("qwen2-1.5b", True, True),
                                               ("olmoe-1b-7b", False, False)])
def test_sharded_lm_train_step_matches_single_device(arch, tp_only, mask):
    single, sharded = run_both(arch, tp_only=tp_only, mask=mask, lr=constant(1e-3))
    assert_sharded_step_close(single, sharded)
    # the moments stay laid out as their parameters
    p2, o2 = sharded[0], sharded[1]
    for p, m in zip(tree_leaves(p2), tree_leaves(o2.mu)):
        assert m.spec == p.spec and m.blocks[1, 3].shape == p.blocks[1, 3].shape


def test_sharded_step_at_the_reference_tests_inputs():
    """The reference's sharded case (default schedule, no mask) with
    ``grad_specs`` pinned to the parameters' specs, as its dry run passes."""
    single, sharded = run_both("qwen2-1.5b", grad_specs=lambda rules, p: spec_for(rules, p))
    assert_sharded_step_close(single, sharded)


def test_grad_specs_other_than_the_params_are_relaid():
    replicated = lambda rules, p: jax.tree.map(  # noqa: E731
        lambda s: P(*([None] * len(s))), spec_for(rules, p),
        is_leaf=lambda s: isinstance(s, P))
    single, sharded = run_both("qwen2-1.5b", grad_specs=replicated, lr=constant(1e-3), steps=1)
    assert_sharded_step_close(single, sharded)


def test_sharded_train_state_restores_onto_another_mesh(tmp_path):
    """Save a sharded train state on (2, 4), restore it onto (4, 2), and the
    next step equals the next step on (2, 4)."""
    cfg = REGISTRY["qwen2-1.5b"].smoke_config()
    params = tfm.init_params(cfg, 0, device="cpu")
    step, init = make_lm_train_step(cfg, accum=2, lr=constant(1e-3))
    states = {}
    for shape in [(2, 4), (4, 2)]:
        _, psh, _ = lm_common._param_specs(cfg, cpu_mesh(shape))
        states[shape] = psh, lm_common._opt_state_specs(psh)
    p, o = device_put(tfm.param_tree(params), states[(2, 4)][0]), None
    o = init(p)
    batch = ref_batch(cfg)
    p, o, _ = step(p, o, batch)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"params": p, "opt": o})
    psh, osh = states[(4, 2)]
    got, at, _ = mgr.restore_latest({"params": p, "opt": o}, shardings={"params": psh, "opt": osh})
    assert at == 1 and tree_leaves(got["params"])[0].mesh.devices.shape == (4, 2)
    p_a, _, m_a = step(p, o, batch)
    p_b, _, m_b = step(got["params"], got["opt"], batch)
    assert float(m_a["loss"]) == pytest.approx(float(m_b["loss"]), abs=1e-6)
    for a, b in zip(tree_leaves(p_a), tree_leaves(p_b)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the int8 gradient all-reduce
# ---------------------------------------------------------------------------


G = np.arange(32.0, dtype=np.float32).reshape(8, 4) / 7.0   # the reference test's input


def ref_compress(axis_name, nested=False):
    def body(g, e):
        sync, new_e = jcomp.compress_grads({"w": g}, {"w": e}, axis_name)
        return sync["w"], new_e["w"]
    if nested:  # a (2, 4) mesh: vmap over "model" inside vmap over "data"
        return jax.jit(jax.vmap(jax.vmap(body, axis_name="model"), axis_name="data"))
    return jax.jit(jax.vmap(body, axis_name=axis_name))


@pytest.mark.parametrize("shape", [(8,), (2, 4)])
def test_compress_grads_bit_equal_reference(shape):
    names = ("data",) if len(shape) == 1 else ("data", "model")
    mesh = cpu_mesh(shape, names)
    fn = ref_compress("data", nested=len(shape) == 2)
    g = G.reshape(*shape, 4)
    shards = [{"w": torch.from_numpy(G[s].copy())} for s in range(8)]
    ef = make_error_feedback_state(shards)
    assert all(float(e["w"].abs().sum()) == 0 and e["w"].dtype == torch.float32 for e in ef)
    jef = jnp.zeros_like(jnp.asarray(g))
    groups = G.reshape(*shape, 4) if len(shape) == 1 else G.reshape(2, 4, 4)
    exact = groups.mean(0)                   # the mean over "data", per model column
    for _ in range(3):
        sync, ef = compress_grads(shards, ef, mesh, "data")
        jsync, jef = fn(jnp.asarray(g), jef)
        got = np.stack([s["w"].numpy() for s in sync]).reshape(*shape, 4)
        np.testing.assert_array_equal(got, np.asarray(jsync))
        np.testing.assert_array_equal(np.stack([e["w"].numpy() for e in ef]).reshape(*shape, 4),
                                      np.asarray(jef))
        rel = np.abs(got[0] - exact).max() / (np.abs(exact).max() + 1e-9)
        assert rel < 0.02, rel


def test_compressed_psum_bit_equal_reference():
    mesh = cpu_mesh((8,), ("data",))
    got = compressed_psum([torch.from_numpy(G[s].copy()) for s in range(8)], mesh, "data")
    want = jax.jit(jax.vmap(lambda x: jcomp.compressed_psum(x, "data"), axis_name="data"))(
        jnp.asarray(G))
    np.testing.assert_array_equal(np.stack([x.numpy() for x in got]), np.asarray(want))
    with pytest.raises(ValueError, match="shard values"):
        compressed_psum(got[:3], mesh, "data")
    with pytest.raises(ValueError, match="not in the mesh"):
        compressed_psum(got, mesh, "model")
