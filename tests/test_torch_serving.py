"""The port's LM serving stack against the JAX package's, on the CPU.

``repro_torch.serve.Engine`` against ``repro.serve.Engine`` on the same
reduced models (float32; the JAX parameters carried across by
``params_from_reference``): greedy tokens equal wherever the reference is
not at fault. The reference's prefill steps every slot, which moves the
recurrent state of the other active slots, and a reused slot keeps its
previous request's state; both faults are shown here against the
reference and repaired in the port. Also ``plan_kv`` field for field and
the serving CLI.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import plan_kv as jax_plan_kv
from repro_torch.configs import ALL_ARCHS
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model, get_config, list_archs, \
    params_from_reference
from repro_torch.serve import Engine, Request, plan_kv

DECODERS = [a for a in list_archs() if a != "hubert-xlarge"]
MATCHED = ["gemma3-1b", "qwen2.5-3b", "granite-moe-1b-a400m"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread. More only spin
    against the other test workers (the three LM test files took 401 s of
    CPU for 70 s of wall on 3 workers with 8 threads each, 155 s for 43 s
    with one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small(cfg, **kw):
    """The JAX package's serving-test shapes (``tests/test_serving.py``:
    d 64, vocab 64, window 8, pattern LG), with 3 layers and the MoE and
    recurrent widths kept."""
    base = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=0,
                d_ff=128, vocab=64, dtype="float32", remat=False,
                window=min(cfg.window, 8) or 0,
                layer_pattern=cfg.layer_pattern and "LG" or "",
                lru_width=64 if cfg.lru_width else 0,
                n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 2),
                n_vision_tokens=0)
    base.update(kw)
    return dataclasses.replace(cfg, **base)


@pytest.fixture(scope="module")
def pair():
    """name -> (JAX model, JAX params, port model on the CPU with those
    params), built once per architecture in this module (engines update
    their own caches, never a model's parameters)."""
    built = {}

    def get(name):
        if name not in built:
            jm = jax_build(small(jax_config(name)))
            params = jm.init(jax.random.PRNGKey(0))
            tm = build_model(small(get_config(name)), device="cpu")
            params_from_reference(tm, jax.tree.map(np.asarray, params))
            built[name] = jm, params, tm
        return built[name]
    return get


def port_model(name, seed=0):
    return build_model(small(get_config(name)), device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def batch_of_requests(make, vocab=64):
    rng = np.random.RandomState(0)
    return [make(i, rng.randint(0, vocab, size=3 + 4 * (i % 3)), 4 + i % 3)
            for i in range(5)]


@pytest.mark.parametrize("name", MATCHED)
def test_engine_greedy_matches_reference(pair, name):
    """One request whose prompt (11 tokens) and output cross the local
    layers' window of 8, so their rings wrap."""
    jm, params, tm = pair(name)
    prompt = np.random.RandomState(3).randint(0, 64, size=11)
    exp = JaxEngine(jm, params, n_slots=1, max_len=48).run(
        [JaxRequest(rid=0, prompt=prompt, max_new=8)])
    got = Engine(tm, n_slots=1, max_len=48).run(
        [Request(rid=0, prompt=prompt, max_new=8)])
    assert got == exp and len(got[0]) == 8


@pytest.mark.parametrize("name", MATCHED)
def test_continuous_batching_matches_reference(pair, name):
    """5 requests over 2 slots: every token list equals the reference's."""
    jm, params, tm = pair(name)
    exp = JaxEngine(jm, params, n_slots=2, max_len=64).run(
        batch_of_requests(lambda i, p, n: JaxRequest(rid=i, prompt=p,
                                                     max_new=n)))
    got = Engine(tm, n_slots=2, max_len=64).run(
        batch_of_requests(lambda i, p, n: Request(rid=i, prompt=p,
                                                  max_new=n)))
    assert sorted(got) == [0, 1, 2, 3, 4]
    assert got == exp
    assert [len(got[i]) for i in range(5)] == [4, 5, 6, 4, 5]


def test_engine_matches_manual_greedy():
    """The port's copy of the JAX package's test: the engine's tokens equal
    a hand-written ``decode_step`` loop."""
    m = port_model("gemma3-1b")
    prompt = np.array([3, 7, 11, 2, 9, 4, 4, 8, 1, 5], np.int64)
    res = Engine(m, n_slots=1, max_len=48).run(
        [Request(rid=0, prompt=prompt, max_new=6)])
    caches = m.decode_init(1, 48)
    for t, tok in enumerate(prompt):
        lg, caches = m.decode_step(caches, torch.tensor([tok]),
                                   torch.tensor([t]))
    out = [int(lg[0].argmax())]
    pos = len(prompt)
    for _ in range(5):
        lg, caches = m.decode_step(caches, torch.tensor([out[-1]]),
                                   torch.tensor([pos]))
        out.append(int(lg[0].argmax()))
        pos += 1
    assert res[0] == out


def _admit_mid_stream(eng, make, steps_before=2):
    """Request 0 alone for ``steps_before`` steps, then request 1."""
    eng.add_request(make(0, np.array([5, 6, 7]), 8))
    res = {}
    for _ in range(steps_before):
        res.update({c.rid: c.tokens for c in eng.step()})
    eng.add_request(make(1, np.array([9, 1, 4, 4]), 4))
    while eng.active.any():
        res.update({c.rid: c.tokens for c in eng.step()})
    return res


def test_reference_prefill_moves_other_slots_state(pair):
    """The reference's fault (rwkv6): admitting a request while another is
    generating changes the first one's tokens; the port's do not move."""
    jm, params, tm = pair("rwkv6-1.6b")

    def jreq(i, p, n):
        return JaxRequest(rid=i, prompt=p, max_new=n)

    def treq(i, p, n):
        return Request(rid=i, prompt=p, max_new=n)
    solo = JaxEngine(jm, params, 2, 64).run([jreq(0, np.array([5, 6, 7]),
                                                  8)])
    jmid = _admit_mid_stream(JaxEngine(jm, params, 2, 64), jreq)
    assert jmid[0] != solo[0]
    tsolo = Engine(tm, 2, 64).run([treq(0, np.array([5, 6, 7]), 8)])
    assert tsolo == solo
    assert _admit_mid_stream(Engine(tm, 2, 64), treq)[0] == solo[0]


def test_reference_reused_slot_keeps_previous_state(pair):
    """The reference's second fault (rwkv6): a request served in a slot an
    earlier request used starts from that request's recurrent state; the
    port's starts from zero and equals the request served alone."""
    jm, params, tm = pair("rwkv6-1.6b")
    a, b = np.array([9, 1, 4, 4]), np.array([5, 6, 7])
    solo = JaxEngine(jm, params, 1, 64).run([JaxRequest(0, b, 8)])
    reused = JaxEngine(jm, params, 1, 64).run([JaxRequest(0, a, 4),
                                               JaxRequest(1, b, 8)])
    assert reused[1] != solo[0]
    got = Engine(tm, 1, 64).run([Request(0, a, 4), Request(1, b, 8)])
    assert got[1] == solo[0]


def test_reference_returns_two_tokens_for_max_new_one(pair):
    """The reference's third fault (qwen2.5, a 5-token prompt): the step
    after the prefill appends a token before it checks ``max_new``, so
    ``max_new=1`` returns 2 tokens (``max_new=3`` returns 3). The port
    completes such a request at admission with its prefill token, and
    the tokens it returns are the reference's first ones."""
    jm, params, tm = pair("qwen2.5-3b")
    prompt = np.array([5, 9, 2, 7, 3])
    j1 = JaxEngine(jm, params, 2, 32).run([JaxRequest(0, prompt, 1)])
    j3 = JaxEngine(jm, params, 2, 32).run([JaxRequest(0, prompt, 3)])
    assert len(j1[0]) == 2 and len(j3[0]) == 3
    t1 = Engine(tm, 2, 32).run([Request(0, prompt, 1)])
    t3 = Engine(tm, 2, 32).run([Request(0, prompt, 3)])
    assert t1[0] == j1[0][:1] and t3[0] == j3[0]


@pytest.mark.parametrize("max_new", [0, 1])
def test_request_met_by_its_prefill_completes_at_admission(max_new):
    """No decode step, the slot free at once; the next ``step`` returns
    the ``Completed`` (also beside a generating slot, whose tokens stay
    its solo run's)."""
    m = port_model("gemma3-1b")
    solo = Engine(m, 2, 64).run([Request(0, np.array([5, 6, 7]), 6)])
    eng = Engine(m, 2, 64)
    assert eng.add_request(Request(0, np.array([5, 6, 7]), 6))
    assert eng.add_request(Request(1, np.array([4, 4, 1]), max_new))
    assert eng.active.tolist() == [True, False] and eng.req[1] is None
    pos = eng.pos.copy()
    done = {c.rid: c.tokens for c in eng.step()}
    assert list(done) == [1] and len(done[1]) == max_new
    assert eng.pos[0] == pos[0] + 1
    while eng.active.any():
        done.update({c.rid: c.tokens for c in eng.step()})
    assert done[0] == solo[0]
    idle = Engine(m, 1, 64)
    assert idle.add_request(Request(7, np.array([2]), max_new))
    assert [c.rid for c in idle.step()] == [7] and idle.step() == []
    got = Engine(m, 1, 64).run([Request(i, np.array([2, i]), max_new)
                                for i in range(3)])
    assert sorted(got) == [0, 1, 2]
    assert all(len(t) == max_new for t in got.values())


def _state_of(eng, slot):
    return [t[:, slot].clone() for seg in eng.caches for sub in seg
            for t in sub.values()]


@pytest.mark.parametrize("name", DECODERS)
def test_admission_leaves_other_slots_bit_for_bit(name):
    """Every decoder family: admitting a request leaves the generating
    slot's caches and recurrent state bit for bit as they were, and its
    tokens equal its solo run."""
    m = port_model(name)

    def req(i, p, n):
        return Request(rid=i, prompt=p, max_new=n)
    solo = Engine(m, 2, 64).run([req(0, np.array([5, 6, 7]), 8)])
    eng = Engine(m, 2, 64)
    eng.add_request(req(0, np.array([5, 6, 7]), 8))
    eng.step()
    before = _state_of(eng, 0)
    eng.add_request(req(1, np.array([9, 1, 4, 4, 2, 8, 3, 3, 6, 1]), 4))
    for a, b in zip(before, _state_of(eng, 0)):
        assert torch.equal(a, b)
    res = {}
    while eng.active.any():
        res.update({c.rid: c.tokens for c in eng.step()})
    assert res[0] == solo[0] and len(res[1]) == 4


def test_sampling_is_seeded_and_prompt_is_checked():
    m = port_model("qwen2.5-3b")
    reqs = [Request(rid=i, prompt=np.array([1 + i, 2, 3]), max_new=12,
                    temperature=0.8) for i in range(3)]
    a = Engine(m, 2, 64, seed=5).run(reqs)
    assert a == Engine(m, 2, 64, seed=5).run(reqs)
    assert a != Engine(m, 2, 64, seed=6).run(reqs)
    eng = Engine(m, 2, 16)
    for bad in (np.array([], np.int64), np.arange(16)):
        with pytest.raises(ValueError, match="prompt"):
            eng.add_request(Request(rid=9, prompt=bad))


@pytest.mark.parametrize("max_len", [64, 4096, 32768])
@pytest.mark.parametrize("name", ALL_ARCHS)
def test_plan_kv_matches_reference(name, max_len):
    got = plan_kv(get_config(name), max_len)
    exp = jax_plan_kv(jax_config(name), max_len)
    assert dataclasses.asdict(got) == dataclasses.asdict(exp)
    assert got.batch_budget(16 << 30) == exp.batch_budget(16 << 30)


def test_kv_planner_rings_and_recurrent_state():
    """The port's copies of the JAX package's planner tests."""
    cfg = get_config("gemma3-1b")
    plan = plan_kv(cfg, max_len=32768)
    kinds = [e["kind"] for e in plan.per_layer]
    assert kinds.count("G") == 4 and kinds.count("L") == 22
    for e in plan.per_layer:
        assert e["ring_tokens"] == (cfg.window if e["kind"] == "L"
                                    else 32768)
    full = 2 * 32768 * cfg.n_kv_heads * cfg.hd * 2 * 26
    assert plan.bytes_per_seq < 0.3 * full  # local rings save >70%
    rwkv = get_config("rwkv6-1.6b")
    assert plan_kv(rwkv, 1024).bytes_per_seq == \
        plan_kv(rwkv, 1 << 19).bytes_per_seq
    m = build_model(small(get_config("gemma3-1b")), device="meta")
    for seg, sc in zip(m.segments, m.decode_init(2, 4096)):
        for kind, sub in zip(seg.kinds, sc):
            assert sub["k"].shape[2] == (8 if kind == "L" else 4096)


def test_serve_cli_runs_on_cpu(capsys):
    assert serve_cli.main(["--arch", "gemma3-1b", "--reduced", "--device",
                           "cpu", "--requests", "3", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "kv plan:" in out and out.count("req ") == 3
    assert "on cpu" in out
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_cli.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                        "cpu"])
