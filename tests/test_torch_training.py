"""Training in the port (``repro_torch.training``, ``models.loss_fn``,
``layers.chunked_ce_loss``) against ``repro``'s on the same inputs (f32,
CPU, weights bridged from the reference's):

- ``MarkovTokenStream`` / ``batches``: the same batches bit for bit;
- ``cosine_schedule`` within 1e-7 relative, ``global_norm`` and the clip
  within 1e-6;
- AdamW over 3 steps on bridged params and seeded gradients (clip and
  weight decay on): parameters and both moments within 1e-6 relative of
  the reference's in f32; bf16 parameters within one bf16 step, their
  moments f32;
- ``chunked_ce_loss`` (ragged last chunk, a mask) and ``loss_fn`` values
  within 1e-5 relative and gradients within 1e-4 of the largest, against
  ``jax.value_and_grad``, for the Llama-2, Granite-3-2B (tied embeddings)
  and InternVL2 (vision prefix) smoke configs with ``attn_impl`` flash
  (the flash kernel's autograd Function, plain versions both ways; remat
  per layer or in groups) and naive;
- ``train`` over 3 steps from bridged weights: the losses step for step
  within 1e-5 relative, the final parameters within 1e-5 absolute;
- checkpoints: f32 from the reference into the port and back, a bf16
  tree bit for bit, the reference's bf16 file read bit for bit;
- ``check_trainable`` takes every registered config; training refuses
  a mesh whose size is not the process group's (meshes train:
  ``tests/test_torch_train_mesh.py``, ``tests/test_torch_train_tp.py``).
  MoE, MLA, Whisper, RG-LRU and Mamba-2
  training have files of their own (``tests/test_torch_train_*.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training as J
import repro_torch.configs.base as tbase
import repro_torch.training as T
from repro.configs import SMOKE_FACTORIES
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models.layers import chunked_ce_loss as j_chunked_ce
from repro.training import checkpoint as j_ckpt
from repro.training.data import MarkovTokenStream as JStream
from repro.training.data import batches as j_batches
from repro_torch.models import model as tm
from repro_torch.models.layers import chunked_ce_loss as t_chunked_ce
from repro_torch.training import checkpoint as t_ckpt
from repro_torch.training.data import MarkovTokenStream as TStream
from repro_torch.training.data import batches as t_batches
from repro_torch.training.optim import tree_leaves
from repro_torch.weights import params_from_numpy

LOSS_REL, GRAD_REL = 1e-5, 1e-4


def port_config(cfg):
    """The same ModelConfig, built from the port's copy of the classes."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(tbase, type(v).__name__)
            return cls(**{f.name: conv(getattr(v, f.name))
                          for f in dataclasses.fields(v)})
        return v
    return conv(cfg)


def bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# data, schedule, norm, optimizer
# ---------------------------------------------------------------------------
def test_markov_batches_equal_bit_for_bit():
    for vocab, B, S, seed in ((512, 3, 40, 0), (49_155, 2, 16, 7)):
        for jb, tb in zip(j_batches(vocab, B, S, 3, seed),
                          t_batches(vocab, B, S, 3, seed)):
            assert jb.keys() == tb.keys()
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(jb[k], tb[k])
    np.testing.assert_array_equal(JStream(300, 3).sample(2, 9, 5),
                                  TStream(300, 3).sample(2, 9, 5))


def test_schedule_norm_and_clip():
    js, ts = J.cosine_schedule(3e-4, 2, 8), T.cosine_schedule(3e-4, 2, 8)
    for step in range(0, 11):
        assert ts(step) == pytest.approx(float(js(jnp.asarray(step))),
                                         rel=1e-7)
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    assert float(T.global_norm(bridge(tree))) == pytest.approx(
        float(J.global_norm(tree)), rel=1e-6)
    # the clip: gradients 10x the clip norm scale down to it
    opt_j = J.AdamW(lr=1.0, grad_clip=1.0)
    opt_t = T.AdamW(lr=1.0, grad_clip=1.0)
    big = jax.tree.map(lambda a: a * 10, tree)
    pj, sj = opt_j.update(big, opt_j.init(tree), tree)
    pt, st = opt_t.update(bridge(big), opt_t.init(bridge(tree)), bridge(tree))
    for a, b in zip(jax.tree.leaves(sj["mu"]), tree_leaves(st["mu"])):
        assert rel_err(b.numpy(), a) <= 1e-6
    clipped = np.sqrt(sum((np.asarray(m) ** 2).sum()
                          for m in tree_leaves(st["mu"]))) / 0.1
    assert clipped == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_reference(dtype):
    rng = np.random.default_rng(1)
    shapes = {"w": (6, 5), "n": {"s": (5,), "t": (2, 3, 4)}}
    params = jax.tree.map(lambda s: jnp.asarray(
        rng.standard_normal(s), getattr(jnp, dtype)), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    sched = (J.cosine_schedule(1e-2, 1, 3), T.cosine_schedule(1e-2, 1, 3))
    opt_j = J.AdamW(lr=sched[0], weight_decay=0.01, grad_clip=2.0)
    opt_t = T.AdamW(lr=sched[1], weight_decay=0.01, grad_clip=2.0)
    pj, sj = params, opt_j.init(params)
    pt = bridge(params)
    st = opt_t.init(pt)
    for step in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape) * (step + 1), p.dtype), params)
        pj, sj = opt_j.update(g, sj, pj)
        pt, st = opt_t.update(bridge(g), st, pt)
    assert st["step"] == int(sj["step"]) == 3
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(sj[name]), tree_leaves(st[name])):
            assert b.dtype == torch.float32
            assert rel_err(b.numpy(), a) <= 1e-6, name
    for a, b in zip(jax.tree.leaves(pj), tree_leaves(pt)):
        a = np.asarray(a, np.float32)
        got = b.float().numpy()
        if dtype == "float32":
            assert rel_err(got, a) <= 1e-6
        else:
            assert b.dtype == torch.bfloat16
            step = 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)
            assert np.abs(got - a).max() <= step


# ---------------------------------------------------------------------------
# the loss and its gradient
# ---------------------------------------------------------------------------
def test_chunked_ce_loss_value_and_grad():
    rng = np.random.default_rng(2)
    B, S, d, V = 2, 40, 16, 50
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    table = (rng.standard_normal((V, d)) * 0.1).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    for m in (None, mask):
        def jf(x, table):
            return j_chunked_ce({"table": table}, x, jnp.asarray(labels),
                                chunk=16, mask=None if m is None
                                else jnp.asarray(m))
        jl, (jgx, jgt) = jax.value_and_grad(jf, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(table))
        tx, tt = (torch.from_numpy(a).requires_grad_() for a in (x, table))
        tl = t_chunked_ce({"table": tt}, tx, torch.from_numpy(labels),
                          chunk=16, mask=None if m is None
                          else torch.from_numpy(m))
        gx, gt = torch.autograd.grad(tl, (tx, tt))
        assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_REL)
        assert rel_err(gx.numpy(), jgx) <= GRAD_REL
        assert rel_err(gt.numpy(), jgt) <= GRAD_REL


LOSS_CASES = [
    ("llama2-7b", "flash", dict(remat=True)),
    ("llama2-7b", "naive", {}),
    ("granite-3-2b", "flash", dict(remat=True, n_layers=4, remat_group=2)),
    ("granite-3-2b", "naive", {}),
    ("internvl2-76b", "flash", dict(remat=True)),
    ("internvl2-76b", "naive", {}),
]


@pytest.mark.parametrize("arch,impl,kw", LOSS_CASES,
                         ids=[f"{a}-{i}" for a, i, _ in LOSS_CASES])
def test_loss_fn_value_and_grad_match_reference(arch, impl, kw):
    jcfg = dataclasses.replace(SMOKE_FACTORIES[arch](), attn_impl=impl,
                               **kw)
    tcfg = port_config(jcfg)
    jp = j_init_params(jax.random.key(4), jcfg)
    rng = np.random.default_rng(3)
    B, S = 2, 24
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.standard_normal(
            (B, jcfg.n_frontend_tokens, jcfg.d_model)).astype(np.float32)
    jl, jg = jax.value_and_grad(j_loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tp = bridge(jp)
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tl = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                    tcfg)
    grads = torch.autograd.grad(tl, leaves)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_REL)
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    got = dict(zip(_paths(tp), grads))
    assert len(got) == len(want)
    for path, w in want:
        key = "/".join(p.key for p in path)
        assert rel_err(got[key].numpy(), w) <= GRAD_REL, key


def _paths(tree, prefix=""):
    """The leaves' paths in ``tree_leaves`` order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _paths(v, f"{prefix}{k}/")
        else:
            out.append(f"{prefix}{k}")
    return out


@pytest.mark.parametrize("arch,impl,kw", [
    ("llama2-7b", "flash", dict(remat=True, remat_group=0)),
    ("granite-3-2b", "naive", dict(remat=False)),
], ids=["llama2-7b-flash-remat", "granite-3-2b-naive"])
def test_train_three_steps_match_reference(arch, impl, kw):
    jcfg = dataclasses.replace(SMOKE_FACTORIES[arch](), attn_impl=impl,
                               **kw)
    tc = dict(batch=2, seq_len=32, steps=3, log_every=1, warmup=1, seed=5)
    jparams, jl = J.train(jcfg, J.TrainConfig(**tc), log=lambda s: None)
    tp = bridge(j_init_params(jax.random.key(5), jcfg))
    tparams, tl = T.train(port_config(jcfg), T.TrainConfig(**tc), params=tp,
                          device="cpu", log=lambda s: None)
    assert [s for s, _ in tl] == [s for s, _ in jl] == [0, 1, 2]
    for (_, a), (_, b) in zip(jl, tl):
        assert b == pytest.approx(a, rel=LOSS_REL)
    # Adam divides each element's moment by its own root mean square, so
    # an element whose gradient sits at rounding level moves by a few
    # 1e-6 either way (measured: one element of 65 536, 2.3e-6)
    for path, want in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = tparams
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.detach().numpy(), want, rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_round_trips(tmp_path):
    rng = np.random.default_rng(6)
    tree = {"embed": {"table": rng.standard_normal((5, 4)).astype(
        np.float32)}, "stages": {"stage_0": {"ln1": {"scale": np.ones(
            (2, 4), np.float32)}}}}
    # f32: the reference's file into the port, the port's into the
    # reference
    j_ckpt.save(str(tmp_path / "j.npz"), tree)
    got = t_ckpt.restore(str(tmp_path / "j.npz"))
    for path, want in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = got
        for p in path:
            node = node[p.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), want)
    t_ckpt.save(str(tmp_path / "t.npz"), bridge(tree))
    back = j_ckpt.restore(str(tmp_path / "t.npz"))
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    # bf16: the port's own round trip and the reference's file, bit for
    # bit; restore(like=) casts and places as the template
    bf = jax.tree.map(lambda a: jnp.asarray(a * 3.7, jnp.bfloat16), tree)
    t_bf = bridge(bf)
    t_ckpt.save(str(tmp_path / "bf.npz"), t_bf)
    j_ckpt.save(str(tmp_path / "jbf.npz"), bf)
    for f in ("bf.npz", "jbf.npz"):
        got = t_ckpt.restore(str(tmp_path / f))
        for a, b in zip(tree_leaves(t_bf), tree_leaves(got)):
            assert b.dtype == torch.bfloat16 and torch.equal(a, b)
    like = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=torch.float64),
                        tree)
    got = t_ckpt.restore(str(tmp_path / "t.npz"), like=like)
    assert all(t.dtype == torch.float64 for t in tree_leaves(got))
    # an optimizer state: its step comes back as the template's int
    opt = T.AdamW()
    st = opt.init(t_bf)
    st["step"] = 7
    t_ckpt.save(str(tmp_path / "opt.npz"), st)
    assert t_ckpt.restore(str(tmp_path / "opt.npz"), like=st)["step"] == 7


# ---------------------------------------------------------------------------
# what training takes and refuses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", tbase.list_archs())
def test_check_trainable_accepts_every_registered_config(arch):
    """Every registered config trains (Mamba-2 since its SSD scan has a
    backward kernel), as registered and as its smoke config."""
    tm.check_trainable(tbase.get_config(arch))
    tm.check_trainable(port_config(SMOKE_FACTORIES[arch]()))


def test_train_refuses_a_mesh():
    """A mesh whose size is not the process group's (a model axis of 2
    over a group of one rank) is refused by name; a model axis itself
    trains (tests/test_torch_train_tp.py)."""
    from repro_torch.launch.mesh import make_host_mesh

    class Mesh:
        shape = {"data": 1, "model": 2}
        axis_names = ("data", "model")
        size = 2

    cfg = port_config(SMOKE_FACTORIES["llama2-7b"]())
    assert not torch.distributed.is_initialized()
    make_host_mesh(device="cpu")
    try:
        with pytest.raises(ValueError,
                           match="the mesh holds 2 of the group's 1 ranks"):
            T.train(cfg, T.TrainConfig(steps=1), mesh=Mesh(), device="cpu")
    finally:
        torch.distributed.destroy_process_group()
