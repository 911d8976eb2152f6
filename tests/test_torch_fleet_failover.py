"""The port's fleet failure plane against the reference, on the fleet half
of test_failover.py: dense, paged and recurrent kills at two seeds, two
deaths, the partition blip, resurrection riding the prefix cache,
``forget_lane``, a group member's death and the failure log.

As in test_torch_fleet.py, each case runs once on each package with the
same weights and holds the reference's own assertions on both runs: the
port's tokens equal its own unkilled engine's, and the greedy requests'
tokens, ``FleetSnapshot.as_dict()`` field by field and the failure log
equal the reference's.  The kill cases also run on all-greedy traffic.
"""
import math

import numpy as np
import pytest

from test_torch_fleet import _pair, greedy_tokens, make_both, on_both, one_thread  # noqa: F401


@pytest.fixture(scope="module")
def both():
    return make_both({"lm": _pair("granite-8b", 2, 0), "rnn": _pair("rwkv6-1.6b", None, 1)})


def _profile(m, name, rate=20.0):
    return m.DeviceProfile(name=name, year=2024, flops=1e12, mem_bytes=8e9, mem_bw=60e9,
                           link_bw=1e9, decode_steps_per_s=rate, prefill_tokens_per_s=1e9)


def _engine_config(m, backend):
    return m.EngineConfig(kv_blocks=48, kv_block_size=4) if backend == "paged" else None


def _traffic(m, model, n, seed, greedy=False):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=6 + i).astype(np.int32)
               for i in range(n)]
    samplings = [m.SamplingParams(temperature=2.0, top_k=32, seed=300 + i)
                 if i % 2 and not greedy else None for i in range(n)]
    return prompts, samplings


def _reference(m, model, params, prompts, samplings, backend=None):
    ref = m.ServeEngine(model, params, max_batch=len(prompts), max_len=48,
                        config=_engine_config(m, backend))
    for p, sp in zip(prompts, samplings):
        ref.submit(p, max_new=8, sampling=sp)
    return {r.rid: r.out_tokens for r in ref.run_until_drained()}


def _chaos_fleet(m, model, params, trace, *, names=("a", "b"), backend=None, failover=None):
    workers = [m.WorkerSpec(n, _profile(m, f"dev-{n}"), max_batch=4,
                            engine_config=_engine_config(m, backend)) for n in names]
    return m.ServingFleet(model, params, workers, max_len=48, tick_s=0.05,
                          kill_trace=trace, failover=failover)


def _drive(m, fleet, prompts, samplings):
    m.drive_sim(fleet, np.linspace(0.0, 0.3, len(prompts)),
                lambda i: fleet.submit(prompts[i], max_new=8, sampling=samplings[i]))


def _result(fleet, samplings):
    return greedy_tokens(fleet, samplings), fleet.snapshot().as_dict(), fleet.failure_log


def _tokens(fleet) -> dict:
    return {rec.req.rid: rec.req.out_tokens for rec in fleet.completed}


KILL_CASES = ([(b, s, "mixed") for s in (3, 4) for b in ("dense", "paged", "recurrent")]
              + [(b, 3, "greedy") for b in ("dense", "paged", "recurrent")])


@pytest.mark.parametrize("backend,seed,traffic", KILL_CASES,
                         ids=["-".join(map(str, c)) for c in KILL_CASES])
def test_fleet_kill_is_token_identical(both, backend, seed, traffic):
    def scenario(m):
        model, params = m.rnn if backend == "recurrent" else m.lm
        prompts, samplings = _traffic(m, model, 6, seed, greedy=traffic == "greedy")
        trace = m.make_kill_trace(["b"], 1, t0_s=0.4, t1_s=0.6, seed=seed)
        fleet = _chaos_fleet(m, model, params, trace, backend=backend)
        _drive(m, fleet, prompts, samplings)
        snap = fleet.snapshot()
        assert snap.completed == len(prompts)
        assert snap.deaths == 1 and snap.dead_units == ("b",)
        assert snap.resurrections >= 1 and snap.orphaned == 0
        assert _tokens(fleet) == _reference(m, model, params, prompts, samplings, backend)
        for name in ("a", "b"):
            eng = fleet.worker(name).engine
            if hasattr(eng.backend, "blocks"):
                assert eng.backend.blocks.in_use == 0
        return _result(fleet, samplings)
    on_both(both, scenario)


def test_fleet_two_deaths_still_drains(both):
    def scenario(m):
        model, params = m.lm
        prompts, samplings = _traffic(m, model, 6, 9)
        trace = m.make_kill_trace(["b", "c"], 2, t0_s=0.4, t1_s=0.9, seed=1)
        fleet = _chaos_fleet(m, model, params, trace, names=("a", "b", "c"))
        _drive(m, fleet, prompts, samplings)
        snap = fleet.snapshot()
        assert snap.completed == len(prompts)
        assert snap.deaths == 2 and set(snap.dead_units) == {"b", "c"}
        assert _tokens(fleet) == _reference(m, model, params, prompts, samplings)
        return _result(fleet, samplings)
    on_both(both, scenario)


def test_fleet_partition_blip_is_transparent(both):
    def scenario(m):
        model, params = m.lm
        prompts, samplings = _traffic(m, model, 4, 5)
        trace = m.KillTrace(events=(m.KillEvent(t_s=0.4, worker="b", kind="partition",
                                                down_s=0.3),))
        fleet = _chaos_fleet(m, model, params, trace,
                             failover=m.FailoverConfig(dead_after=40.0, suspect_after=20.0))
        _drive(m, fleet, prompts, samplings)
        snap = fleet.snapshot()
        assert snap.completed == len(prompts)
        assert snap.deaths == 0 and snap.resurrections == 0 and snap.dead_units == ()
        assert _tokens(fleet) == _reference(m, model, params, prompts, samplings)
        return _result(fleet, samplings)
    on_both(both, scenario)


def test_fleet_resurrection_rides_the_prefix_cache(both):
    def scenario(m):
        model, params = m.lm
        prompt = np.random.default_rng(21).integers(
            0, model.cfg.vocab_size, size=12).astype(np.int32)

        def run(prefix_cache):
            cfg = m.EngineConfig(kv_blocks=48, kv_block_size=4, prefix_cache=prefix_cache)
            workers = [m.WorkerSpec(n, _profile(m, f"dev-{n}"), max_batch=2, engine_config=cfg)
                       for n in ("a", "b")]
            trace = m.KillTrace(events=(m.KillEvent(t_s=0.45, worker="b", kind="crash"),))
            fleet = m.ServingFleet(model, params, workers, max_len=48, tick_s=0.05,
                                   kill_trace=trace,
                                   failover=m.FailoverConfig(checkpoint_every_s=1e9))
            m.drive_sim(fleet, np.array([0.0, 0.05]),
                        lambda i: fleet.submit(prompt, max_new=4 if i == 0 else 16))
            return fleet
        warm, cold = run(True), run(False)
        for fleet in (warm, cold):
            snap = fleet.snapshot()
            assert snap.completed == 2 and snap.deaths == 1
        assert warm.worker("a").engine.metrics.prefill_skipped >= 1
        assert warm.recompute_tokens < cold.recompute_tokens
        assert {rec.req.rid: len(rec.req.out_tokens) for rec in warm.completed} == {0: 4, 1: 16}
        return (_tokens(warm), _tokens(cold), warm.snapshot().as_dict(),
                cold.snapshot().as_dict(), warm.failure_log)
    on_both(both, scenario)


def test_forget_lane_frees_blocks_without_feeding_the_cache(both):
    def scenario(m):
        model, params = m.lm
        prompt = np.random.default_rng(13).integers(
            0, model.cfg.vocab_size, size=8).astype(np.int32)
        eng = m.ServeEngine(model, params, max_batch=2, max_len=48,
                            config=m.EngineConfig(kv_blocks=32, kv_block_size=4,
                                                  prefix_cache=True))
        eng.submit(prompt, max_new=6)
        for _ in range(3):
            eng.step()
        held = eng.backend.blocks.in_use
        assert held > 0
        req = eng.forget_lane(0)
        assert req.rid == 0 and req.preemptions == 1
        assert eng.backend.blocks.in_use == 0
        full_ctx = np.concatenate([prompt, np.asarray(req.out_tokens, np.int32)])
        cached = eng.backend.cached_prefix_tokens(full_ctx)
        assert cached <= len(prompt)
        with pytest.raises(ValueError):
            eng.forget_lane(0)
        return held, list(req.out_tokens), cached
    on_both(both, scenario)


def test_fleet_group_member_death_kills_the_unit(both):
    def scenario(m):
        model, params = m.lm
        grp = m.StageGroup("pair", (m.WorkerSpec("s0", _profile(m, "d0")),
                                    m.WorkerSpec("s1", _profile(m, "d1"))),
                           cuts=(1,), max_batch=2)
        trace = m.KillTrace(events=(m.KillEvent(t_s=0.4, worker="s1", kind="crash"),))
        fleet = m.ServingFleet(model, params, [m.WorkerSpec("solo", _profile(m, "ds"))],
                               groups=[grp], max_len=48, tick_s=0.05, kill_trace=trace)
        prompts, samplings = _traffic(m, model, 6, 17)
        _drive(m, fleet, prompts, samplings)
        snap = fleet.snapshot()
        assert snap.completed == len(prompts)
        assert snap.deaths == 1 and snap.dead_units == ("pair",)
        assert _tokens(fleet) == _reference(m, model, params, prompts, samplings)
        assert all(rec.worker == "solo" for rec in fleet.completed if rec.migrated)
        return _result(fleet, samplings)
    on_both(both, scenario)


def test_fleet_failure_log_narrates_the_episode(both):
    def scenario(m):
        model, params = m.lm
        prompts, samplings = _traffic(m, model, 4, 23)
        trace = m.KillTrace(events=(m.KillEvent(t_s=0.4, worker="b", kind="crash"),))
        fleet = _chaos_fleet(m, model, params, trace)
        _drive(m, fleet, prompts, samplings)
        kinds = [k for _, k, _ in fleet.failure_log]
        assert kinds[0] == "kill:crash"
        assert "dead" in kinds and "resurrect" in kinds
        assert "suspect" in kinds[:kinds.index("dead")]
        assert fleet.snapshot().checkpoints > 0
        assert not math.isnan(fleet.snapshot().goodput_tokens_per_s)
        return _result(fleet, samplings)
    on_both(both, scenario)
