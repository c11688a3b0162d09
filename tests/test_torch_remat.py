"""ray_tpu_torch's remat policies and ``RTPU_CE_CHUNK`` against the JAX
package's, on the CPU.

Every policy of JAX's ``_remat_wrap`` (``none``, ``full``, ``attn``,
``attn+``, ``dots``, ``dots+``, and for Llama a per-layer mix) runs in
the port's Llama, ViT and Mixtral. For each, the loss and every gradient
leaf of one JAX ``init_params`` tree (``params_from_jax``) and one numpy
batch are held against ``jax.value_and_grad`` of JAX's loss under the
same policy: loss within 1e-5, each gradient within 1e-4 of its leaf's
largest value (the tolerances of tests/test_torch_train.py; f32, sums in
other orders). JAX's flash attention runs its blockwise path on the CPU,
the port its kernels' plain twins.

What each policy recomputes is counted on the CPU the way the card counts
kernel launches: calls to ``rms_norm`` (K1 on the card) and to
``flash_attention`` (K2) during the backward, and the matrix products the
backward runs (a ``dots`` policy re-runs none). The ``cuda``-marked test
counts the kernels' own launches on the card.

JAX is imported inside the tests: on a card machine, which has no JAX,
``python -m pytest --noconftest tests/test_torch_remat.py -m cuda`` runs
the card's test alone.
"""

from collections import Counter
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu_torch._device import tree_map
from ray_tpu_torch.models import llama, mixtral, vit
from ray_tpu_torch.ops import loss as loss_ops

F32_TOL = 1e-5
GRAD_TOL = 1e-4
POLICIES = ["none", "full", "attn", "attn+", "dots", "dots+"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().float().cpu().numpy()
    return {prefix[:-1]: np.asarray(tree, dtype=np.float32)}


def _port_value_and_grad(loss_of, params):
    leaves = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss = loss_of(leaves)
    loss.backward()
    return loss.item(), tree_map(lambda t: t.grad, leaves)


def _assert_matches(got, grads, want, wgrads):
    np.testing.assert_allclose(got, float(want), rtol=F32_TOL, atol=F32_TOL)
    want_g, got_g = _flat(wgrads), _flat(grads)
    assert want_g.keys() == got_g.keys()
    for name, w in want_g.items():
        err = np.abs(got_g[name] - w).max() / max(np.abs(w).max(), 1e-12)
        assert err < GRAD_TOL, (name, err)


def _tokens(vocab, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


# -- the policies against JAX -------------------------------------------------

@pytest.mark.parametrize("remat", POLICIES + ["dots:1,attn:1"])
def test_llama_policy_matches_jax(remat):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    jcfg = jl.LlamaConfig.tiny()
    jp = jl.init_params(jcfg, jax.random.PRNGKey(3))
    tokens, targets = _tokens(jcfg.vocab_size, seed=3)
    want, wgrads = jax.value_and_grad(
        lambda p: jl.loss_fn(jcfg, p, jnp.asarray(tokens),
                             jnp.asarray(targets), attn_impl="flash",
                             remat=remat))(jp)
    got, grads = _port_value_and_grad(
        lambda p: llama.loss_fn(llama.LlamaConfig.tiny(), p,
                                torch.from_numpy(tokens),
                                torch.from_numpy(targets), attn_impl="flash",
                                remat=remat),
        llama.params_from_jax(jp, "cpu"))
    _assert_matches(got, grads, want, wgrads)


@pytest.mark.parametrize("remat", POLICIES)
def test_vit_policy_matches_jax(remat):
    """JAX's ViT takes ``use_pallas=False`` ("blockwise"): its reference
    attention, exact as the Pallas kernels are."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import vit as jv

    jcfg = jv.ViTConfig.tiny()
    jp = jv.init_params(jcfg, jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    images = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, 2).astype(np.int32)
    want, wgrads = jax.value_and_grad(
        lambda p: jv.loss_fn(jcfg, p, jnp.asarray(images),
                             jnp.asarray(labels), attn_impl="blockwise",
                             remat=remat))(jp)
    got, grads = _port_value_and_grad(
        lambda p: vit.loss_fn(vit.ViTConfig.tiny(), p,
                              torch.from_numpy(images),
                              torch.from_numpy(labels), attn_impl="flash",
                              remat=remat),
        vit.params_from_jax(jp, "cpu"))
    _assert_matches(got, grads, want, wgrads)


@pytest.mark.parametrize("remat", POLICIES)
def test_mixtral_policy_matches_jax(remat):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import mixtral as jm

    jcfg = jm.MixtralConfig.tiny()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(5))
    tokens, targets = _tokens(jcfg.vocab_size, s=16, seed=5)
    want, wgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, jnp.asarray(tokens),
                             jnp.asarray(targets), attn_impl="flash",
                             remat=remat))(jp)
    got, grads = _port_value_and_grad(
        lambda p: mixtral.loss_fn(mixtral.MixtralConfig.tiny(), p,
                                  torch.from_numpy(tokens).long(),
                                  torch.from_numpy(targets).long(),
                                  attn_impl="flash", remat=remat),
        mixtral.params_from_jax(jp, "cpu"))
    _assert_matches(got, grads, want, wgrads)


# -- what each policy recomputes ----------------------------------------------

class _Products(TorchDispatchMode):
    """Counts the matrix products that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _model_case(name):
    """(config, params, loss of params under a policy, modules whose
    ``rms_norm`` and ``flash_attention`` names the model calls)."""
    if name == "llama":
        cfg = llama.LlamaConfig.tiny()
        tok, tgt = (torch.from_numpy(a) for a in _tokens(cfg.vocab_size))
        return (cfg, llama.init_params(cfg, 1, device="cpu"),
                lambda p, r: llama.loss_fn(cfg, p, tok, tgt, remat=r),
                (llama,))
    if name == "vit":
        cfg = vit.ViTConfig.tiny()
        images = torch.rand((2, 16, 16, 3),
                            generator=torch.Generator().manual_seed(1))
        labels = torch.tensor([1, 7])
        return (cfg, vit.init_params(cfg, 1, device="cpu"),
                lambda p, r: vit.loss_fn(cfg, p, images, labels, remat=r),
                (vit,))
    cfg = mixtral.MixtralConfig.tiny()
    tok, tgt = (torch.from_numpy(a).long()
                for a in _tokens(cfg.vocab_size, s=16))
    return (cfg, mixtral.init_params(cfg, 1, device="cpu"),
            lambda p, r: mixtral.loss_fn(cfg, p, tok, tgt, remat=r),
            (llama, mixtral))


def _backward_counts(monkeypatch, name, remat):
    cfg, params, loss_of, mods = _model_case(name)
    calls = Counter()

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    for mod in mods:
        for key in ("rms_norm", "flash_attention"):
            if hasattr(mod, key):
                monkeypatch.setattr(mod, key, counted(key, getattr(mod, key)))
    leaves = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss = loss_of(leaves, remat)
    forward = Counter(calls)
    with _Products() as products:
        loss.backward()
    return cfg.num_layers, forward, calls - forward, products.n


# Recomputed in the backward, per layer: (rms_norm calls, flash calls).
# The card's K1/K2 launches per step are the forward's plus these.
RECOMPUTE = {
    "llama": {"none": (0, 0), "full": (2, 1), "attn": (2, 0),
              "attn+": (2, 0), "dots": (2, 0), "dots+": (0, 0)},
    # The ViT and Mixtral layers name no norm output: dots+ is dots.
    "vit": {"none": (0, 0), "full": (2, 1), "attn": (2, 0),
            "attn+": (2, 0), "dots": (2, 0), "dots+": (2, 0)},
}
RECOMPUTE["mixtral"] = RECOMPUTE["vit"]


@pytest.mark.parametrize("name", ["llama", "vit", "mixtral"])
@pytest.mark.parametrize("remat", POLICIES)
def test_policy_recomputes_what_it_should(monkeypatch, name, remat):
    n_layers, fwd, bwd, products = _backward_counts(monkeypatch, name, remat)
    _, _, _, products_none = _backward_counts(monkeypatch, name, "none")
    norms, flashes = RECOMPUTE[name][remat]
    assert fwd["rms_norm"] == 2 * n_layers + 1
    assert fwd["flash_attention"] == n_layers
    assert bwd["rms_norm"] == norms * n_layers
    assert bwd["flash_attention"] == flashes * n_layers
    if remat in ("none", "dots", "dots+"):
        assert products == products_none  # no product re-runs
    else:
        assert products > products_none


def test_llama_mix_recomputes_each_run_under_its_own_policy(monkeypatch):
    cfg, params, loss_of, _ = _model_case("llama")
    assert cfg.num_layers == 2
    counts = {}
    for spec in ("dots+:1,attn:1", "attn:1,dots+:1", "dots:1,full:1"):
        _, _, bwd, _ = _backward_counts(monkeypatch, "llama", spec)
        counts[spec] = (bwd["rms_norm"], bwd["flash_attention"])
    assert counts == {"dots+:1,attn:1": (2, 0), "attn:1,dots+:1": (2, 0),
                      "dots:1,full:1": (4, 1)}


# -- RTPU_CE_CHUNK ------------------------------------------------------------

@pytest.mark.parametrize("env", ["8", "12", None, "0", "x", "-4"])
def test_ce_chunk_env_reaches_the_loss_as_in_jax(monkeypatch, env):
    """``default_ce_chunk`` resolves the variable as JAX's does (unset,
    unparsable or <= 0: 512), ``loss_fn`` hands that value to
    ``fused_cross_entropy`` (12 does not divide S 32: one chunk), and the
    loss is JAX's under the same variable."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu.ops import loss as jloss

    if env is None:
        monkeypatch.delenv("RTPU_CE_CHUNK", raising=False)
    else:
        monkeypatch.setenv("RTPU_CE_CHUNK", env)
    assert loss_ops.default_ce_chunk() == jloss.default_ce_chunk()
    seen = []
    real = llama.fused_cross_entropy

    def spy(x, head, targets, mask=None, chunk=512, **kw):
        seen.append(chunk)
        return real(x, head, targets, mask, chunk, **kw)

    monkeypatch.setattr(llama, "fused_cross_entropy", spy)
    jcfg = jl.LlamaConfig.tiny()
    jp = jl.init_params(jcfg, jax.random.PRNGKey(6))
    tokens, targets = _tokens(jcfg.vocab_size, seed=6)
    want = jl.loss_fn(jcfg, jp, jnp.asarray(tokens), jnp.asarray(targets),
                      remat="none")
    got = llama.loss_fn(llama.LlamaConfig.tiny(),
                        llama.params_from_jax(jp, "cpu"),
                        torch.from_numpy(tokens), torch.from_numpy(targets),
                        remat="none")
    assert seen == [jloss.default_ce_chunk()]
    np.testing.assert_allclose(got.item(), float(want), rtol=F32_TOL,
                               atol=F32_TOL)


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("remat", POLICIES + ["dots:1,attn:1"])
def test_llama_launches_and_grads_on_card(remat):
    """K1/K2/K3 launches of one step under each policy at 2 layers
    (head_dim 64, bf16), and the gradients of ``none`` bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.ops import norms

    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=512, num_layers=2, num_heads=4,
                            num_kv_heads=2, head_dim=64, max_seq_len=256)
    params = llama.init_params(cfg, 2, device="cuda")
    tokens, targets = (torch.from_numpy(a).cuda()
                       for a in _tokens(cfg.vocab_size, s=128))
    counters = (norms.rms_norm, att.flash_fwd_cuda, att.flash_bwd_cuda)

    def run(spec):
        for c in counters:
            c.launches = 0
        loss, grads = _port_value_and_grad(
            lambda p: llama.loss_fn(cfg, p, tokens, targets, remat=spec),
            params)
        torch.cuda.synchronize()
        return loss, _flat(grads), tuple(c.launches for c in counters)

    loss0, g0, _ = run("none")
    loss, grads, launches = run(remat)
    per_layer = [RECOMPUTE["llama"][p] for p in
                 ([remat] * 2 if ":" not in remat else ["dots", "attn"])]
    L = cfg.num_layers
    assert launches == (2 * L + 1 + sum(n for n, _ in per_layer),
                        L + sum(f for _, f in per_layer), L)
    assert loss == loss0
    for name, w in g0.items():
        np.testing.assert_array_equal(grads[name], w, err_msg=name)


def test_remat_of_a_layer_count_it_was_not_made_for_raises():
    cfg = replace(llama.LlamaConfig.tiny(), num_layers=3)
    with pytest.raises(ValueError, match="entries"):
        llama.forward_hidden(cfg, llama.init_params(cfg, 0, device="cpu"),
                             torch.zeros((1, 4), dtype=torch.long),
                             remat="dots:1,attn:1")
