"""ray_tpu_torch.autotune against ray_tpu.autotune, on the CPU.

The memory model is JAX's arithmetic: ``predict_hbm`` (every component,
byte for byte) and ``remat_flops_factor`` over every candidate of
``candidate_space(16)`` at the 1.1B bench geometry (bench.py) and of
``candidate_space(8)`` at ``llama3_8b()``'s widths, under both
optimizers. The space is JAX's less its flash block candidates. The
search, driven by one fake ``measure_fn`` on both sides, takes the same
decisions: the trace row by row, the order of measurement, pruning, the
cache, and the fallback to the cached champion when every measurement
fails.
"""

from dataclasses import replace

import pytest

from ray_tpu.autotune import model as jmodel
from ray_tpu.autotune import search as jsearch
from ray_tpu.autotune import space as jspace
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu_torch import autotune
from ray_tpu_torch.autotune import model, search, space
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.ops.loss import default_ce_chunk

BENCH = dict(vocab_size=32128, hidden_size=2048, intermediate_size=8192,
             num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
             max_seq_len=2048, tie_embeddings=True, dtype="bfloat16")
SEQ = 2048


def _geometry(name):
    """(port config, JAX config, layers of the space)."""
    if name == "bench_1b":
        return LlamaConfig(**BENCH), JaxLlamaConfig(**BENCH), 16
    return (replace(LlamaConfig.llama3_8b(), num_layers=8),
            replace(JaxLlamaConfig.llama3_8b(), num_layers=8), 8)


def _both_spaces(num_layers, **kw):
    want = [c for c in jspace.candidate_space(num_layers, **kw)
            if not (c.flash_block_q or c.flash_block_k)]
    return want, space.candidate_space(num_layers, **kw)


def test_all_is_jaxs():
    import ray_tpu.autotune as jax_autotune

    assert autotune.__all__ == jax_autotune.__all__


@pytest.mark.parametrize("kw", [{}, {"batches": (4, 8)},
                                {"include_zero1": False, "opt": "adamw"},
                                {"include_grad_accum": False,
                                 "include_kernel_knobs": False}])
@pytest.mark.parametrize("num_layers", [16, 8, 2, 1])
def test_candidate_space_is_jaxs_less_flash_blocks(num_layers, kw):
    want, got = _both_spaces(num_layers, **kw)
    assert [c.label for c in got] == [c.label for c in want]
    assert [c.step_options() for c in got] == \
        [c.step_options() for c in want]
    assert [c.env_overrides() for c in got] == \
        [c.env_overrides() for c in want]


@pytest.mark.parametrize("opt", ["lowmem", "adamw"])
@pytest.mark.parametrize("name", ["bench_1b", "llama3_8b_8l"])
def test_predict_hbm_is_jaxs_byte_for_byte(name, opt):
    cfg, jcfg, layers = _geometry(name)
    want, got = _both_spaces(layers, opt=opt)
    for w, c in zip(want, got):
        a = jmodel.predict_hbm(jcfg, SEQ, w)
        b = model.predict_hbm(cfg, SEQ, c)
        assert b.total_bytes == a.total_bytes, c.label
        assert b.components == a.components, c.label
        assert b.total_gb == a.total_gb
        assert model.remat_flops_factor(c.remat, layers) == \
            jmodel.remat_flops_factor(w.remat, layers)
        for shards in (2, 4):
            assert model.predict_hbm(cfg, SEQ, c, shards).total_bytes == \
                jmodel.predict_hbm(jcfg, SEQ, w, shards).total_bytes


@pytest.mark.parametrize("env", [None, "256", "2048", "3000"])
def test_predict_hbm_prices_the_process_ce_chunk_as_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("RTPU_CE_CHUNK", raising=False)
    else:
        monkeypatch.setenv("RTPU_CE_CHUNK", env)
    cfg, jcfg, _ = _geometry("bench_1b")
    for remat in ("dots", "attn"):
        cand = space.Candidate(batch=4, remat=remat)
        jcand = jspace.Candidate(batch=4, remat=remat)
        assert model.predict_hbm(cfg, SEQ, cand).components == \
            jmodel.predict_hbm(jcfg, SEQ, jcand).components


def test_optimizer_state_bytes_count_what_jax_counts():
    cfg, jcfg, _ = _geometry("bench_1b")
    for opt in ("lowmem", "adamw"):
        assert model._optimizer_state_bytes(cfg, opt) == \
            jmodel._optimizer_state_bytes(jcfg, opt)


def test_score_is_jaxs():
    cfg, jcfg, _ = _geometry("bench_1b")
    want, got = _both_spaces(16)
    for budget in (None, 80 << 30, 16 << 30):
        for w, c in zip(want, got):
            pred = model.predict_hbm(cfg, SEQ, c).total_bytes
            assert search._score(c, cfg, pred, budget) == \
                jsearch._score(w, jcfg, pred, budget)
    assert search.geometry_sig(cfg, SEQ, 1) == \
        jsearch.geometry_sig(jcfg, SEQ, 1)


def _fake_measure(fail=()):
    """tokens/s from the label alone, a raise for labels in ``fail``,
    and the order in which candidates were measured."""
    order = []

    def measure(cand):
        order.append(cand.label)
        if cand.label in fail or "*" in fail:
            raise RuntimeError(f"CUDA out of memory measuring {cand.label}")
        tps = 1000.0 + sum(map(ord, cand.label)) % 997
        return {"tokens_per_sec": tps,
                "measured_hbm_gb": round(tps / 100, 3), "hbm_source": "fake"}

    return measure, order


def _run_both(tmp_path, scenario, budget_gb):
    cfg, jcfg, _ = _geometry("bench_1b")
    want_c, got_c = _both_spaces(16, batches=(4, 8))
    out = []
    for side, mod, c, cands in (("jax", jsearch, jcfg, want_c),
                                ("port", search, cfg, got_c)):
        cache = mod.AutotuneCache(str(tmp_path / f"{side}.json"))
        budget = budget_gb << 30
        fail = {"*"} if scenario == "all_fail" else {cands[1].label}
        measure, order = _fake_measure(fail)
        if scenario in ("cache_rerun", "all_fail"):
            # a first round banks measurements in the cache
            mod.autotune_train_configs(
                c, SEQ, cands, hbm_budget_bytes=budget,
                measure_fn=_fake_measure()[0], max_measure=4, cache=cache,
                device_kind="H100")
            order.clear()
        res = mod.autotune_train_configs(
            c, SEQ, cands, hbm_budget_bytes=budget,
            measure_fn=None if scenario == "cache_rerun" else measure,
            max_measure=5, cache=cache, device_kind="H100")
        out.append((res, order))
    return out


@pytest.mark.parametrize("scenario", ["measure", "cache_rerun", "all_fail"])
@pytest.mark.parametrize("budget_gb", [80, 14])
def test_search_decides_as_jax(tmp_path, scenario, budget_gb):
    (want, want_order), (got, got_order) = _run_both(tmp_path, scenario,
                                                     budget_gb)
    assert got_order == want_order
    assert got.trace == want.trace
    for key in ("winner", "tokens_per_sec", "space_size", "pruned",
                "measured", "failed"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.winner is not None
    if budget_gb == 14:
        assert got.pruned > 0


def test_cache_round_trips_and_keys_by_device_and_geometry(tmp_path):
    path = str(tmp_path / "c.json")
    c = search.AutotuneCache(path)
    c.put("NVIDIA H100 80GB HBM3", "g", "b4/dots/flash/lowmem",
          {"tokens_per_sec": 5.0})
    again = search.AutotuneCache(path)
    assert again.get("NVIDIA H100 80GB HBM3", "g",
                     "b4/dots/flash/lowmem")["tokens_per_sec"] == 5.0
    assert again.get("other", "g", "b4/dots/flash/lowmem") is None
    assert search.AutotuneCache.key("a", "b", "c") == \
        jsearch.AutotuneCache.key("a", "b", "c")


def test_hbm_budget_env_wins_and_a_cpu_device_has_none(monkeypatch):
    monkeypatch.setenv("RTPU_HBM_BUDGET_GB", "1.5")
    assert model.device_hbm_budget_bytes() == int(1.5 * (1 << 30)) == \
        jmodel.device_hbm_budget_bytes()
    assert model.device_hbm_budget_bytes("cpu") == int(1.5 * (1 << 30))
    monkeypatch.setenv("RTPU_HBM_BUDGET_GB", "lots")
    assert model.device_hbm_budget_bytes("cpu") is None
    monkeypatch.delenv("RTPU_HBM_BUDGET_GB")
    assert model.device_hbm_budget_bytes("cpu") is None
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.device_hbm_budget_bytes()


def test_a_flash_block_candidate_is_refused():
    cand = space.Candidate(batch=4, remat="attn", flash_block_q=256,
                           flash_block_k=256)
    assert cand.label == jspace.Candidate(
        batch=4, remat="attn", flash_block_q=256, flash_block_k=256).label
    with pytest.raises(NotImplementedError, match="Hopper"):
        cand.env_overrides()
    with pytest.raises(NotImplementedError, match="Hopper"):
        with cand.applied_env():
            pass
    assert all(not (c.flash_block_q or c.flash_block_k)
               for c in space.candidate_space(16))


def test_applied_env_sets_the_ce_chunk_and_restores_it(monkeypatch):
    monkeypatch.setenv("RTPU_CE_CHUNK", "128")
    cand = space.Candidate(batch=4, remat="dots", ce_chunk=1024)
    assert cand.env_overrides() == {"RTPU_CE_CHUNK": "1024"}
    with cand.applied_env():
        assert default_ce_chunk() == 1024
    assert default_ce_chunk() == 128
    assert space.with_overrides(cand, ce_chunk=None).env_overrides() == {}
    assert [c.label for c in space.legacy_candidates(
        [(4, "attn", "flash", "lowmem")])] == ["b4/attn/flash/lowmem"]
