"""Batch LLM inference: ray_tpu_torch.data.llm against ray_tpu.data.llm.

One JAX initialization of the tiny Llama drives both sides: ray_tpu's
processor makes it from ``LLMConfig(seed=0)`` inside its pool actor, the
port's engines get the same weights through ``params_from_jax`` on the
CPU. Greedy generations (text and token counts) must be equal row for
row, in order (map_batches over an actor pool keeps block order). A pool
of two engines gives the same rows, takes the runtime's "GPU" resource
while it runs and gives it back, with its engines stopped, before the
iteration returns.
"""

import gc

import jax
import pytest

import ray_tpu
import ray_tpu.data as jdata
import ray_tpu_torch
import ray_tpu_torch.data as tdata
from ray_tpu.data.llm import ProcessorConfig as JaxProcessorConfig
from ray_tpu.data.llm import build_llm_processor as jax_build
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.models.llama import init_params as jax_init_params
from ray_tpu_torch.data.llm import ProcessorConfig, build_llm_processor
from ray_tpu_torch.llm import LLMConfig, LLMEngine
from ray_tpu_torch.models.llama import params_from_jax

KW = dict(model="tiny", max_num_seqs=2, max_seq_len=64)
SAMPLING = {"max_tokens": 5, "temperature": 0.0}
PROMPTS = [f"say {i} {'x' * (i % 4)}" for i in range(6)]


def _rows(rows):
    return [(r["prompt"], r["generated_text"], int(r["num_generated_tokens"]))
            for r in rows]


@pytest.fixture(scope="module")
def jax_rows():
    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=8)
    try:
        proc = jax_build(JaxLLMConfig(**KW), config=JaxProcessorConfig(
            batch_size=4, concurrency=1, sampling=SAMPLING))
        return _rows(proc(jdata.from_items(
            [{"prompt": p} for p in PROMPTS])).take_all())
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def params():
    jcfg = JaxLLMConfig(**KW).model_config()
    return params_from_jax(jax_init_params(jcfg, jax.random.PRNGKey(0)),
                           "cpu")


def test_generations_match_ray_tpu_data_llm(jax_rows, params):
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    try:
        proc = build_llm_processor(
            LLMConfig(**KW), params=params, device="cpu",
            config=ProcessorConfig(batch_size=4, concurrency=1,
                                   sampling=SAMPLING))
        got = _rows(proc(tdata.from_items(
            [{"prompt": p} for p in PROMPTS])).take_all())
    finally:
        ray_tpu_torch.shutdown()
    assert len(got) == len(PROMPTS)
    assert got == jax_rows


def test_a_pool_of_two_engines_releases_the_card(jax_rows, params):
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, resources={"GPU": 1})
    try:
        proc = build_llm_processor(
            LLMConfig(**KW), params=params, device="cpu", num_gpus=0.5,
            config=ProcessorConfig(batch_size=2, concurrency=2,
                                   sampling=SAMPLING))
        got = _rows(proc(tdata.from_items(
            [{"prompt": p} for p in PROMPTS])).take_all())
        assert got == jax_rows
        assert ray_tpu_torch.available_resources()["GPU"] == 1.0
        gc.collect()
        engines = [o for o in gc.get_objects() if type(o) is LLMEngine]
        assert not [e for e in engines if e._thread.is_alive()]
    finally:
        ray_tpu_torch.shutdown()
