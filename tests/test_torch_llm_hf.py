"""ray_tpu_torch's checkpoint loading against the JAX package's.

``convert_hf_llama`` of an in-memory ``transformers`` LlamaForCausalLM
(built from a small config with random weights: nothing is downloaded)
equals JAX's conversion leaf by leaf in f32, exactly; an engine on a
``save_pretrained`` directory gives JAX's engine's tokens; ``config_from_hf``
maps and refuses rope scalings as JAX's does; a save_pytree (DCP)
directory round-trips through ``checkpoint_path`` and
``speculative_checkpoint_path``. The transformers tests skip where the
package is missing.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu.llm.hf import config_from_hf as jax_config_from_hf
from ray_tpu.llm.hf import convert_hf_llama as jax_convert_hf_llama

from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm.hf import config_from_hf, convert_hf_llama
from ray_tpu_torch.models.llama import LlamaConfig, init_params
from ray_tpu_torch.train.checkpoint import save_pytree

HF_KW = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             max_position_embeddings=128, rope_theta=10000.0,
             rms_norm_eps=1e-5, attn_implementation="eager")


def _hf_model(vocab, tie=False):
    tfs = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = tfs.LlamaConfig(vocab_size=vocab, tie_word_embeddings=tie, **HF_KW)
    return tfs.LlamaForCausalLM(cfg).eval()


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("tie", [False, True])
def test_convert_hf_llama_matches_jax_leaf_by_leaf(tie):
    model = _hf_model(256, tie)
    jcfg, jparams = jax_convert_hf_llama(model, dtype="float32")
    tcfg, tparams = convert_hf_llama(model, dtype="float32")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = dict(_leaves(jparams))
    got = dict(_leaves(tparams))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]),
                                      err_msg=name)
    # And the converted params reproduce transformers' own logits.
    from ray_tpu_torch.models.llama import forward

    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (2, 17)))
    with torch.no_grad():
        ref = model(tokens).logits.float()
        ours = forward(tcfg, tparams, tokens, remat="none")
    torch.testing.assert_close(ours.float(), ref, rtol=2e-3, atol=2e-3)


def test_convert_bf16_matches_jax():
    model = _hf_model(256)
    _, jparams = jax_convert_hf_llama(model)  # default bfloat16
    _, tparams = convert_hf_llama(model)
    want = dict(_leaves(jparams))
    for name, t in _leaves(tparams):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(want[name]).astype(np.float32))


def test_engine_on_hf_directory_matches_jax_engine(tmp_path):
    """checkpoint_path = a save_pretrained directory: geometry and weights
    come from it (vocab 512 fits the byte tokenizer), and the port's
    greedy tokens equal JAX's engine's on the same directory."""
    _hf_model(512).save_pretrained(tmp_path / "hf")
    kw = dict(model="tiny", dtype="float32",
              checkpoint_path=str(tmp_path / "hf"), max_num_seqs=2,
              max_seq_len=64)
    jeng = JaxLLMEngine(JaxLLMConfig(**kw))
    teng = LLMEngine(LLMConfig(**kw), device="cpu")
    try:
        assert teng.model_cfg.hidden_size == 64  # from the checkpoint
        assert dataclasses.asdict(teng.model_cfg) == \
            dataclasses.asdict(jeng.model_cfg)
        for prompt in ("hi", "a longer prompt for the checkpoint"):
            sp = SamplingParams(max_tokens=8)
            assert teng.generate(prompt, sp).token_ids == \
                jeng.generate(prompt, sp).token_ids, prompt
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_directory_without_transformers_raises(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        convert_hf_llama(str(tmp_path))


def test_in_memory_state_dict_object_converts_without_transformers(
        monkeypatch):
    """Any object with .config.to_dict() and .state_dict() converts: an HF
    state dict built from this package's params by transposing round-trips
    exactly."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    cfg = dataclasses.replace(LlamaConfig.tiny(), rope_theta=10000.0)
    params = init_params(cfg, generator=3, device="cpu")
    lay = params["layers"]
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    sd = {"model.embed_tokens.weight": params["embed_tokens"],
          "model.norm.weight": params["final_norm"],
          "lm_head.weight": params["lm_head"].t()}
    for i in range(cfg.num_layers):
        for ours, hf in names.items():
            sd[f"model.layers.{i}.{hf}.weight"] = lay[ours][i].t()
        sd[f"model.layers.{i}.input_layernorm.weight"] = lay["attn_norm"][i]
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = \
            lay["mlp_norm"][i]
    hf_cfg = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                  intermediate_size=cfg.intermediate_size,
                  num_hidden_layers=cfg.num_layers,
                  num_attention_heads=cfg.num_heads,
                  num_key_value_heads=cfg.num_kv_heads,
                  head_dim=cfg.head_dim,
                  max_position_embeddings=cfg.max_seq_len,
                  rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps)

    class Source:
        config = type("C", (), {"to_dict": staticmethod(lambda: hf_cfg)})

        @staticmethod
        def state_dict():
            return dict(sd)

    got_cfg, got = convert_hf_llama(Source(), dtype="float32")
    assert got_cfg == cfg
    for name, t in _leaves(params):
        assert torch.equal(dict(_leaves(got))[name], t), name


def test_config_from_hf_rope_scaling_as_jax():
    base = dict(vocab_size=128256, hidden_size=2048, intermediate_size=8192,
                num_hidden_layers=16, num_attention_heads=32,
                num_key_value_heads=8, rope_theta=500000.0,
                tie_word_embeddings=True, max_position_embeddings=131072)
    llama3 = dict(base, rope_scaling={
        "rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 8192})
    assert dataclasses.asdict(config_from_hf(llama3)) == \
        dataclasses.asdict(jax_config_from_hf(llama3))
    assert config_from_hf(llama3).rope_scaling["factor"] == 32.0
    for kind in ("linear", "dynamic", "yarn"):
        bad = dict(base, rope_scaling={"rope_type": kind, "factor": 2.0})
        with pytest.raises(ValueError, match="unsupported rope_scaling"):
            config_from_hf(bad)
        with pytest.raises(ValueError, match="unsupported rope_scaling"):
            jax_config_from_hf(bad)


def test_dcp_checkpoint_round_trips_through_checkpoint_path(tmp_path):
    cfg = LLMConfig(model="tiny", max_num_seqs=2, max_seq_len=64)
    params = init_params(cfg.model_config(), generator=9, device="cpu")
    save_pytree(params, str(tmp_path / "ck"))
    base = LLMEngine(cfg, params=params, device="cpu")
    eng = LLMEngine(LLMConfig(model="tiny", max_num_seqs=2, max_seq_len=64,
                              checkpoint_path=str(tmp_path / "ck")),
                    device="cpu")
    try:
        for name, t in _leaves(params):
            assert torch.equal(dict(_leaves(eng.params))[name], t), name
        sp = SamplingParams(max_tokens=8)
        assert eng.generate("dcp", sp).token_ids == \
            base.generate("dcp", sp).token_ids
    finally:
        base.shutdown()
        eng.shutdown()


def test_dcp_checkpoint_as_the_speculative_draft(tmp_path):
    """speculative_checkpoint_path: the target's own params saved as the
    draft make a perfect draft."""
    cfg = LLMConfig(model="tiny", max_num_seqs=2, max_seq_len=64)
    params = init_params(cfg.model_config(), generator=4, device="cpu")
    save_pytree(params, str(tmp_path / "draft"))
    eng = LLMEngine(LLMConfig(
        model="tiny", max_num_seqs=2, max_seq_len=64,
        speculative_model="tiny", speculative_tokens=3,
        speculative_checkpoint_path=str(tmp_path / "draft")),
        params=params, device="cpu")
    base = LLMEngine(cfg, params=params, device="cpu")
    try:
        sp = SamplingParams(max_tokens=16, temperature=0.0)
        assert eng.generate("draft", sp).token_ids == \
            base.generate("draft", sp).token_ids
        assert eng.stats()["spec_acceptance"] > 0.9
    finally:
        eng.shutdown()
        base.shutdown()


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        LLMEngine(LLMConfig(model="tiny",
                            checkpoint_path=str(tmp_path / "nope")),
                  device="cpu")
