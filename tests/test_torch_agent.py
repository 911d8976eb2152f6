"""The port's agentic tool loop against the JAX package's (mirrors
test_offload.py and test_serving.py's tool-loop test).

``VectorDB`` and ``ToolExecutor`` are host code: the port's give the
reference's search results and FIFO semantics.  ``run_scenario`` drives the
port's ServeEngine (reduced granite, 2 layers, fp32, the JAX weights through
``params_from_jax``): async tools wait under half of sync's, and the
generated tokens are the JAX engine's for the same seed.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest

from repro.configs import RunConfig, get_config, reduced_config
from repro.models.api import build_model
from repro.offload.tools import ToolExecutor as JaxToolExecutor
from repro.offload.vectordb import VectorDB as JaxVectorDB
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeEngine as JaxEngine
from repro.serving.tool_loop import run_scenario as jax_run_scenario
import repro_torch.configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models.api import build_model as tbuild_model
from repro_torch.offload.tools import ToolEvent, ToolExecutor
from repro_torch.offload.vectordb import VectorDB
from repro_torch.serving.engine import EngineConfig, ServeEngine
from repro_torch.serving.tool_loop import AgentTrace, Span, run_scenario

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
QUERIES = ["google search engine", "apple ipod", "microsoft windows"]


@pytest.fixture(scope="module")
def lms():
    cfg = dataclasses.replace(reduced_config(get_config("granite-8b")), n_layers=2)
    model = build_model(cfg, RunConfig(**F32))
    params = model.init(jax.random.key(0))
    tcfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("granite-8b")),
                               n_layers=2)
    tmodel = tbuild_model(tcfg, tconfigs.RunConfig(**F32), device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return model, params, tmodel, tparams


# ---------------------------------------------------------------------------
# vector DB and split-tool FIFO (host code)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_docs,dim,seed", [(500, 32, 1), (3000, 128, 0)])
def test_vectordb_matches_reference(n_docs, dim, seed):
    db, ref = VectorDB(n_docs=n_docs, dim=dim, seed=seed), JaxVectorDB(n_docs, dim, seed)
    np.testing.assert_array_equal(db.embeddings, ref.embeddings)
    for q in QUERIES + ["query"]:
        np.testing.assert_array_equal(db.encode(q), ref.encode(q))   # same process
        for k in (1, 5, 7):
            np.testing.assert_array_equal(db.search_text(q, k), ref.search_text(q, k))


def test_vectordb_topk_correct():
    db = VectorDB(n_docs=500, dim=32, seed=1)
    q = db.encode("query")
    out = db.search(q, 7)
    want = np.argsort(-(db.embeddings @ q))[:7]
    np.testing.assert_array_equal(out[:, 0].astype(int), want)
    assert np.all(np.diff(out[:, 1]) <= 1e-6)


@pytest.mark.parametrize("n_workers", [1, 3])
def test_fifo_order(n_workers):
    """Retrieval is oldest-first whether the calls run one at a time or
    side by side."""
    ex = ToolExecutor(n_workers=n_workers)
    ex.register("t", lambda x: np.asarray([x]), simulated_seconds=0.01)
    events = [ex.begin("t", x=i) for i in range(4)]
    assert all(isinstance(ev, ToolEvent) for ev in events)
    got = [int(ex.retrieve()[0]) for _ in range(4)]
    assert got == [0, 1, 2, 3]                 # oldest first (paper FIFO)
    assert ex.pending() == 0 and all(ev.run_seconds > 0 for ev in events)
    assert all(ev.retrieved_t is not None for ev in ex.events)
    with pytest.raises(LookupError):
        ex.retrieve()
    ex.shutdown()


def test_overlap_eliminates_wait():
    ex = ToolExecutor(n_workers=3)
    ex.register("slow", lambda: np.zeros(1), simulated_seconds=0.25)
    t0 = time.perf_counter()
    for _ in range(3):
        ex.begin("slow")
    time.sleep(0.3)                            # "reasoning" while tools run
    for _ in range(3):
        ex.retrieve()
    assert time.perf_counter() - t0 < 0.55     # serial would be >= 0.75
    ex.shutdown()


def test_wire_payload_roundtrip_matches_reference():
    """Arguments and results cross the port's codec as numpy arrays, the
    reference's values."""
    outs = []
    for cls in (ToolExecutor, JaxToolExecutor):
        ex = cls(n_workers=1)
        ex.register("echo", lambda x, s: np.asarray(x) * s, simulated_seconds=0.0)
        ex.begin("echo", x=np.arange(5, dtype=np.float32), s=2)
        outs.append(ex.retrieve())
        ex.shutdown()
    assert isinstance(outs[0], np.ndarray) and outs[0].dtype == outs[1].dtype
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], np.arange(5) * 2)


# ---------------------------------------------------------------------------
# the scenario
# ---------------------------------------------------------------------------
def _executor(cls, db, seconds):
    ex = cls(n_workers=3)
    ex.register("vector_db_begin_search", lambda query, k: db.search_text(query, int(k)),
                simulated_seconds=seconds)
    return ex


def test_tool_loop_async_removes_idle_and_matches_jax_tokens(lms):
    model, params, tmodel, tparams = lms
    db = VectorDB(n_docs=300, dim=16)
    traces, tokens = {}, {}
    for async_tools in (True, False):
        eng = ServeEngine(tmodel, tparams, max_batch=1, max_len=48)
        ex = _executor(ToolExecutor, db, 0.25)
        traces[async_tools] = run_scenario(eng, ex, QUERIES, async_tools=async_tools,
                                           reason_tokens=6, summary_tokens=8)
        ex.shutdown()
        tokens[async_tools] = [r.out_tokens for r in eng.finished]
    jeng = JaxEngine(model, params, max_batch=1, max_len=48)
    jex = _executor(JaxToolExecutor, JaxVectorDB(300, 16), 0.0)
    jax_run_scenario(jeng, jex, QUERIES, async_tools=True, reason_tokens=6, summary_tokens=8)
    jex.shutdown()
    want = [r.out_tokens for r in jeng.finished]
    assert tokens[True] == tokens[False] == want
    assert [len(t) for t in want] == [6, 8, 8, 8]
    tr_async, tr_sync = traces[True], traces[False]
    # sync waits out 3 x 0.25 s in turn; async overlaps them on 3 workers
    assert tr_sync.time_in("tool_wait") > 0.6
    assert tr_async.time_in("tool_wait") < 0.5 * tr_sync.time_in("tool_wait")
    kinds = [s["kind"] for s in tr_async.timeline()]
    assert kinds == ["reason"] + ["tool_wait", "summarize"] * 3
    assert tr_async.total >= tr_async.time_in("summarize") > 0


def test_tool_loop_prefix_cache_matches_jax(lms):
    """With a 32-token scenario prefix over the paged pool with the prefix
    cache: the JAX engine's tokens and prefix-hit counters."""
    model, params, tmodel, tparams = lms
    kw = dict(kv_blocks=32, kv_block_size=8, prefix_cache=True)
    eng = ServeEngine(tmodel, tparams, max_batch=2, max_len=96, config=EngineConfig(**kw))
    jeng = JaxEngine(model, params, max_batch=2, max_len=96, config=JaxEngineConfig(**kw))
    db = VectorDB(n_docs=300, dim=16)
    for e, cls, run in ((eng, ToolExecutor, run_scenario),
                        (jeng, JaxToolExecutor, jax_run_scenario)):
        ex = _executor(cls, db, 0.0)
        run(e, ex, QUERIES, async_tools=True, reason_tokens=4, summary_tokens=5,
            prefix_tokens=32, seed=3)
        ex.shutdown()
    assert [r.out_tokens for r in eng.finished] == [r.out_tokens for r in jeng.finished]
    snap, jsnap = eng.metrics_snapshot(), jeng.metrics_snapshot()
    fields = ("prefix_lookups", "prefix_hit_tokens", "prefix_query_tokens",
              "prefill_dispatches", "completed")
    assert [getattr(snap, f) for f in fields] == [getattr(jsnap, f) for f in fields]
    assert snap.prefix_hit_tokens >= 3 * 32


def test_trace_accounting():
    tr = AgentTrace(spans=[Span("reason", 1.0, 1.5), Span("tool_wait", 1.5, 1.75, "q"),
                           Span("tool_wait", 2.0, 2.5)], t_start=1.0, t_end=3.0)
    assert tr.total == 2.0 and tr.time_in("tool_wait") == 0.75
    assert tr.timeline()[1] == dict(kind="tool_wait", start=0.5, end=0.75, label="q")


def test_launcher_tools_runs_on_cpu(capsys):
    tserve.main(["--tools", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "agent scenario" in out and "device cpu" in out
    assert out.count("summarize") == 3 and out.count("tool_wait") == 4
