"""The port's optimizer and train step against the JAX package's, on the CPU.

The same seeded inputs (numpy) go through ``repro.train`` and
``repro_torch.train``; a training state made by the reference's
``make_train_state`` is carried across by
``models.train_state_from_reference``. Sizes are the JAX package's
reduced ones (``tests/test_models.py``: 4 layers, d 64, vocab 256) and
``tests/test_checkpoint.py``'s ``_tiny_model``.

The reference decays every per-layer tensor: its layers' leaves are
stacked along a leading axis of the segment's depth, so ``_decay_mask``'s
``ndim >= 2`` holds for the norm scales and other 1-d tensors of the
layers (``ROADMAP.md`` C). The port decays 2-d and larger tensors only,
as the reference intends; the step tests run the reference with that
intended mask (``intended_decay``), and
``tests/test_torch_train_archs.py`` shows the difference.

Bounds: the schedule within 1 ULP; the optimizer on seeded trees within
rtol 1e-6; float32 train steps within rtol 1e-5 / atol 1e-6 (loss, grad
norm, new master, m and v). bfloat16 steps are held to bounds measured
on these inputs, written beside their test.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro.train import OptConfig as JOptConfig
from repro.train import make_train_state as jax_train_state
from repro.train import make_train_step as jax_train_step
from repro.train import optimizer as jax_opt
from repro.train.train_loop import _int8_ef_compress as jax_int8
from repro_torch.models import build_model, get_config, list_archs, \
    train_state_from_reference
from repro_torch.models.weights import reference_items
from repro_torch.train import OptConfig, make_train_state, make_train_step
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import _int8_ef_compress

ARCHS = list_archs()
RTOL, ATOL = 1e-5, 1e-6
# the supervisor test's schedule (tests/test_checkpoint.py): a learning
# rate of 5e-4 at step 1, so a wrong update shows
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=30)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread (more only spin against the
    other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reduced(cfg, **extra):
    kw = dict(
        n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128, vocab=256,
        lru_width=64 if cfg.lru_width else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        window=min(cfg.window, 6) if cfg.window else 0,
        n_vision_tokens=4 if cfg.n_vision_tokens else 0,
        remat=False,
    )
    kw.update(extra)
    return dataclasses.replace(cfg, **kw)


def tiny(**extra):
    """``tests/test_checkpoint.py``'s ``_tiny_model`` config."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab=128, dtype="float32", remat=False)
    kw.update(extra)
    return kw


def make_batch(cfg, b=2, s=16, seed=7):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encoder":
        batch["frame_embeds"] = rng.randn(b, s, cfg.d_model).astype(
            np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.randn(
            b, cfg.n_vision_tokens, cfg.d_model).astype(np.float32)
        batch["mrope_positions"] = rng.randint(0, 4 * s, (3, b, s))
    return batch


def intended_decay(monkeypatch, jstate):
    """Make the reference's ``_decay_mask`` decide on each leaf's
    per-layer rank (a leaf under ``segments`` carries one stacked axis).
    ``adamw_update`` asks once per leaf, in leaf order, each trace."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate["opt"]["master"])
    mask = [leaf.ndim - (getattr(path[0], "key", None) == "segments") >= 2
            for path, leaf in flat]
    order = itertools.cycle(mask)
    monkeypatch.setattr(jax_opt, "_decay_mask", lambda leaf: next(order))


def carried(name, reducer, monkeypatch, **extra):
    """(JAX model, JAX train state with the intended decay mask, port
    model, port state carried from it) on the CPU."""
    jm = jax_build(dataclasses.replace(reducer(jax_config(name)), **extra))
    jstate = jax_train_state(jm, jax.random.PRNGKey(0), JOptConfig(**OPT))
    intended_decay(monkeypatch, jstate)
    tm = build_model(dataclasses.replace(reducer(get_config(name)), **extra),
                     device="cpu")
    tstate = train_state_from_reference(tm, jax.tree.map(np.asarray,
                                                         jstate))
    return jm, jstate, tm, tstate


# the share of a state's elements that may sit outside RTOL / ATOL, and
# their own bounds: a master by Adam's step bound (4 x the summed learning
# rate), a moment by 5% of its leaf's largest value, a residual by 3x (one
# int8 level is twice the largest residual). Measured: at most 5 elements
# of a state in the float32 steps; with int8 compression, after 5 steps of
# the tiny model, 611 of 82,496 residual elements (0.74%; one level each,
# from 1 at step 2, each flip moving the next gradients), 89 masters
# (0.11%), 72 first moments, no second moment
FEW, FEW_INT8 = 5e-4, 1e-2
OUTLIER = {"m": 0.05, "v": 0.05, "ef_residual": 3.0}


def assert_close_but_few(pairs, bound, rtol=RTOL, atol=ATOL, few=FEW):
    """``pairs``: (name, port array, reference array). Every element within
    rtol / atol, but up to ``few`` of all elements, which are within
    ``bound(name, reference array)``. Adam divides each element's
    gradient by its RMS, so where a gradient is at rounding level (the key
    bias's gradient is zero in exact arithmetic: softmax ignores a shift
    of all of a query's scores) the frameworks' rounding decides the
    step's sign, and int8 compression moves an element by a whole level
    where the two gradients straddle a rounding boundary."""
    outliers, total = 0, 0
    for name, got, exp in pairs:
        err = np.abs(got - exp)
        bad = err > atol + rtol * np.abs(exp)
        total += exp.size
        if bad.any():
            assert err.max() <= bound(name, exp), (name, err.max(),
                                                   bound(name, exp))
            outliers += int(bad.sum())
    assert outliers <= few * total, (outliers, total)


def assert_state_close(tm, tstate, jstate, lr_sum, keys=("master", "m", "v"),
                       strict=("m", "v"), few=FEW):
    """Every element of ``keys`` within RTOL / ATOL; those not in
    ``strict`` as ``assert_close_but_few`` with OUTLIER's bounds."""
    for key in keys:
        pairs = [(name, tstate["opt"][key][name].numpy(), exp)
                 for name, exp in reference_items(tm, jax.tree.map(
                     np.asarray, jstate["opt"][key]))]
        if key in strict:
            for name, got, exp in pairs:
                np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{key} {name}")
        else:
            assert_close_but_few(pairs, lambda name, exp: (
                4 * lr_sum if key == "master"
                else OUTLIER[key] * np.abs(exp).max()), few=few)


# --------------------------------------------------------------- optimizer
def test_lr_schedule_within_one_ulp():
    for cfg in (dict(), dict(warmup_steps=3, total_steps=40,
                             min_lr_frac=0.25), dict(warmup_steps=0,
                                                     total_steps=1)):
        steps = np.arange(0, 60, dtype=np.int32)
        exp = np.asarray(jax_opt.lr_schedule(JOptConfig(**cfg),
                                             jnp.asarray(steps)))
        got = opt.lr_schedule(OptConfig(**cfg), torch.from_numpy(steps))
        assert got.dtype == torch.float32
        ulp = np.spacing(np.abs(exp).astype(np.float32))
        assert (np.abs(got.numpy() - exp) <= ulp).all(), cfg


def _seeded_tree(rng, shapes):
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("step", [0, 4])
def test_adamw_update_and_global_norm_match(step):
    """Decay on the 2-d and 3-d leaves only; a bf16 parameter is its new
    master cast; the clip engages (grads scaled by 3)."""
    rng = np.random.RandomState(step)
    shapes = {"a": (6, 5), "b": (7,), "c": (2, 3, 4), "d": (1,)}
    master = _seeded_tree(rng, shapes)
    grads = {k: 3 * v for k, v in _seeded_tree(rng, shapes).items()}
    m = {k: 0.1 * v for k, v in _seeded_tree(rng, shapes).items()}
    v = {k: np.abs(0.1 * x) for k, x in _seeded_tree(rng, shapes).items()}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=20)
    jstate = {"step": jnp.int32(step), "master": master, "m": m, "v": v}
    jparams = {k: jnp.asarray(x).astype(jnp.bfloat16 if k == "a"
                                        else jnp.float32)
               for k, x in master.items()}
    jp, js, jmet = jax_opt.adamw_update(JOptConfig(**cfg), jparams, grads,
                                        jstate)

    def t(tree):
        return {k: torch.from_numpy(x.copy()) for k, x in tree.items()}
    params = {k: torch.from_numpy(x).to(torch.bfloat16 if k == "a"
                                        else torch.float32)
              for k, x in master.items()}
    state = {"step": torch.tensor(step, dtype=torch.int32),
             "master": t(master), "m": t(m), "v": t(v)}
    met = opt.adamw_update(OptConfig(**cfg), params, t(grads), state)
    assert int(state["step"]) == step + 1
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                               rtol=1e-6)
    assert float(met["grad_norm"]) > 1.0          # the clip engaged
    for key in ("master", "m", "v"):
        for k in shapes:
            np.testing.assert_allclose(state[key][k].numpy(),
                                       np.asarray(js[key][k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{key} {k}")
    for k in shapes:
        assert params[k].dtype == (torch.bfloat16 if k == "a"
                                   else torch.float32)
        assert torch.equal(params[k], state["master"][k].to(params[k].dtype))
    tree = t(grads)
    np.testing.assert_allclose(float(opt.global_norm(tree)),
                               float(jax_opt.global_norm(grads)), rtol=1e-6)


def test_int8_error_feedback_equal():
    """Equal bit for bit, one scale per tensor: the same quantization
    levels (half to even) and residuals; a zero tensor keeps its 1e-12
    floor."""
    rng = np.random.RandomState(3)
    g = {"a": rng.randn(33, 7).astype(np.float32),
         "b": np.array([0.5, -1.5, 2.5, 127.0, -127.0], np.float32),
         "z": np.zeros((4,), np.float32)}
    jd, je = jax_int8({k: jnp.asarray(v) for k, v in g.items()})
    td, te = _int8_ef_compress({k: torch.from_numpy(v) for k, v in
                                g.items()}, [[k] for k in g])
    for k in g:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("variant", [dict(grad_accum=2),
                                     dict(compress_grads=True),
                                     dict(grad_accum=2,
                                          compress_grads=True)])
def test_tiny_model_five_steps_match_reference(variant, monkeypatch):
    """``_tiny_model`` (qwen2.5, 2 layers, d 64, vocab 128), 5 steps of a
    batch of 4 x 32, with gradient accumulation and with int8
    error-feedback compression: the loss at every step and the final
    state, the residual too."""
    jm, jstate, tm, tstate = carried(
        "qwen2.5-3b", lambda c: dataclasses.replace(c, **tiny()),
        monkeypatch)
    jstep = jax.jit(jax_train_step(jm, JOptConfig(**OPT), **variant))
    tstep = make_train_step(tm, OptConfig(**OPT), **variant)
    compress = variant.get("compress_grads", False)
    lr_sum = 0.0
    for i in range(5):
        batch = make_batch(tm.cfg, b=4, s=32, seed=20 + i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tstate, tmet = tstep(tstate, batch)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=RTOL)
        lr_sum += float(jmet["lr"])
    if compress:
        assert_state_close(tm, tstate, jstate, lr_sum,
                           keys=("master", "m", "v", "ef_residual"),
                           strict=("v",), few=FEW_INT8)
    else:
        assert_state_close(tm, tstate, jstate, lr_sum)


def test_bf16_steps_within_measured_bound(monkeypatch):
    """gemma3 (reduced, bf16 compute, the reference's recipe), 3 steps:
    loss and grad norm per step, and every stored parameter against the
    reference's float32 parameter cast to the stored dtype. Measured on
    these inputs: loss within 1.3e-3 relative, grad norm within 2.7e-3,
    parameters within 1 bf16 ULP at their scale (8e-3 relative) but for
    rare elements whose update sign differs (1e-3 absolute here: 1 of
    ~100k); bounds 4x the loss and norm gaps."""
    jm, jstate, tm, tstate = carried("gemma3-1b", reduced, monkeypatch)
    assert tm.cfg.dtype == "bfloat16"
    jstep = jax.jit(jax_train_step(jm, JOptConfig(**OPT)))
    tstep = make_train_step(tm, OptConfig(**OPT))
    lr_sum = 0.0
    for i in range(3):
        batch = make_batch(tm.cfg, seed=30 + i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tstate, tmet = tstep(tstate, batch)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=5e-3)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-2)
        lr_sum += float(jmet["lr"])
    params = dict(tm.named_parameters())
    pairs = []
    for name, exp in reference_items(tm, jax.tree.map(np.asarray,
                                                      jstate["params"])):
        p = params[name].detach()
        pairs.append((name, p.float().numpy(),
                      torch.from_numpy(np.array(exp)).to(p.dtype).float()
                      .numpy()))
    assert_close_but_few(pairs, lambda name, exp: 4 * lr_sum + 1e-2 * np.abs(
        exp).max(), rtol=1e-2, atol=2e-3)


def test_master_copies_are_the_unrounded_draws():
    """``make_train_state``: master holds the float32 draws (not the bf16
    parameters widened), each parameter is its master cast; after bf16
    steps every parameter still equals its master cast, bit for bit."""
    cfg = reduced(get_config("gemma3-1b"))
    m = build_model(cfg, device="cpu")
    state = make_train_state(m, torch.Generator().manual_seed(0))
    ref = build_model(cfg, device="cpu").init_(
        torch.Generator().manual_seed(0))
    params = dict(m.named_parameters())
    wq = "layers.0.attn.wq"
    assert params[wq].dtype == torch.bfloat16
    assert state["opt"]["master"][wq].dtype == torch.float32
    assert not torch.equal(state["opt"]["master"][wq],
                           params[wq].float())          # unrounded
    for n, p in ref.named_parameters():
        assert torch.equal(params[n], p), n              # init_'s draws
        assert p.requires_grad is False and params[n].requires_grad
    step = make_train_step(m, OptConfig(**OPT))
    for i in range(2):
        step(state, make_batch(cfg, seed=40 + i))
    for n, p in params.items():
        assert torch.equal(p, state["opt"]["master"][n].to(p.dtype)), n


def test_make_train_state_with_compression_holds_a_zero_residual():
    m = build_model(dataclasses.replace(get_config("qwen2.5-3b"), **tiny()),
                    device="cpu")
    state = make_train_state(m, torch.Generator().manual_seed(0),
                             compress_grads=True)
    res = state["opt"]["ef_residual"]
    assert sorted(res) == sorted(state["params"])
    assert all(not t.any() and t.dtype == torch.float32
               for t in res.values())


# -------------------------------------------- the encoder through the CLI
def _hubert_cli(tmp, *args):
    from repro_torch.launch import train as train_cli
    return train_cli.main(["--arch", "hubert-xlarge", "--reduced",
                           "--device", "cpu", "--batch", "2", "--seq", "16",
                           "--ckpt-dir", tmp, *args])


def test_reference_cli_cannot_train_the_encoder(tmp_path):
    """The reference's CLI feeds the encoder tokens only: its first step
    raises ``KeyError: 'frame_embeds'``."""
    from repro.launch import train as jax_train_cli
    with pytest.raises(KeyError, match="frame_embeds"):
        jax_train_cli.main(["--arch", "hubert-xlarge", "--reduced",
                            "--steps", "1", "--batch", "2", "--seq", "16",
                            "--ckpt-dir", str(tmp_path)])


def test_frame_embed_stream_gives_the_specs_and_replays():
    """``frame_embeds`` of ``train_input_specs``' shape and dtype, drawn
    from (seed, step): a stream restored to a step yields that step's
    batch again, bit for bit; another seed or step another draw."""
    from repro_torch.data import TokenStream
    from repro_torch.launch.shapes import train_input_specs
    from repro_torch.launch.train import FrameEmbedStream, reduced_config
    cfg = reduced_config(get_config("hubert-xlarge"))
    a = FrameEmbedStream(TokenStream(cfg.vocab, 2, 16, seed=3), cfg)
    want = train_input_specs(cfg, 2, 16)
    batches = [a.next() for _ in range(3)]
    for b in batches:
        assert sorted(b) == sorted(want)
        x = b["frame_embeds"]
        assert x.shape == want["frame_embeds"].shape
        assert x.dtype == want["frame_embeds"].dtype == torch.bfloat16
        assert abs(float(x.float().std()) - 1.0) < 0.1
    assert not torch.equal(batches[0]["frame_embeds"],
                           batches[1]["frame_embeds"])
    snap = a.snapshot()
    assert snap == {"seed": 3, "step": 3}
    b = FrameEmbedStream(TokenStream(cfg.vocab, 2, 16, seed=3), cfg)
    b.restore({"seed": 3, "step": 1})
    again = b.next()
    for k in again:
        assert np.array_equal(np.asarray(again[k].float()
                                         if k == "frame_embeds"
                                         else again[k]),
                              np.asarray(batches[1][k].float()
                                         if k == "frame_embeds"
                                         else batches[1][k])), k
    other = FrameEmbedStream(TokenStream(cfg.vocab, 2, 16, seed=4), cfg)
    assert not torch.equal(other.next()["frame_embeds"],
                           batches[0]["frame_embeds"])


def test_cli_trains_the_encoder_and_resumes_bit_for_bit(tmp_path, capsys):
    """3 steps of the reduced encoder with finite losses; then 4 steps in
    one run against 2 steps and a ``--resume`` to 4: the final
    checkpoints are equal, bit for bit."""
    from repro_torch.checkpointing import checkpoint as ckpt
    from repro_torch.launch.train import reduced_config
    assert _hubert_cli(str(tmp_path / "a"), "--steps", "3") == 0
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("loss: ")][0]
    first = float(line.split("first=")[1].split()[0])
    last = float(line.split("last=")[1].split()[0])
    assert np.isfinite(first) and np.isfinite(last)
    assert "'steps': 3" in out

    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    assert _hubert_cli(one, "--steps", "4", "--ckpt-every", "2") == 0
    assert _hubert_cli(two, "--steps", "2", "--ckpt-every", "2") == 0
    assert _hubert_cli(two, "--steps", "4", "--ckpt-every", "2",
                       "--resume") == 0
    assert "resumed from step 2" in capsys.readouterr().out
    cfg = reduced_config(get_config("hubert-xlarge"))
    model = build_model(cfg, device="cpu")
    template = make_train_state(model, torch.Generator().manual_seed(1))
    flat = []
    for d in (one, two):
        state, data_state, step = ckpt.restore(d, template)
        assert step == 4 and data_state == {"seed": 0, "step": 4}
        flat.append({k: v.clone()
                     for k, v in ckpt._flatten_with_paths(state)})
    assert sorted(flat[0]) == sorted(flat[1])
    for k in flat[0]:
        assert torch.equal(flat[0][k], flat[1][k]), k


def test_train_lm_example_twin_learns_on_the_cpu():
    """``examples/train_lm_torch.py`` (the JAX package's
    ``examples/train_lm.py`` on the port) with ``--device cpu``: its
    learning assert holds."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "train_lm_torch.py")
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses = mod.main(["--device", "cpu", "--steps", "30"])
    assert len(losses) == 30 and losses[-1] < losses[0]
