"""The dense LM slice (configs, model, weight carry, serve steps) against
the JAX reference at the smoke sizes of glm4-9b (GQA) and codeqwen1.5-7b
(MHA), with the reference's weights carried by ``lm_params_from_reference``.

Tolerances:
* f32: rtol = atol = 2e-3, tests/test_models.py's decode-vs-forward bound.
  The port's attention follows the Pallas kernel (f32 softmax), the
  reference's inline attention the same math in f32.
* bf16: the largest |port - reference| within 3e-2 of the largest
  |logit|. At bf16 the port's attention keeps the Pallas kernel's f32
  scores and p @ v where the reference's inline attention rounds scores
  and probabilities to bf16, so the attention outputs differ by an ulp
  here and there and every later bf16 rounding decorrelates; everything
  else rounds as the reference does (checked bit for bit below). The
  error is therefore measured against the logits' scale, as the card's
  whole-model check measures it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.carry import lm_params_from_reference  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import segment_matmul as sm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ARCHS = ["glm4-9b", "codeqwen1.5-7b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def models(arch, dtype, seed=0):
    """(jax cfg, jax params, port model) with the same weights."""
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_configs.get(arch).smoke_cfg, dtype=jdt,
                               remat=False)
    cfg = dataclasses.replace(configs.get(arch).smoke_cfg, dtype=tdt)
    params = jax_tfm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = tfm.Transformer(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(
        jax.tree.map(np.asarray, params)))
    return jcfg, params, model


def tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    else:
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    spec, ref = configs.get(arch), jax_configs.get(arch)
    assert (spec.family, spec.shapes, spec.skips, spec.source) == \
        (ref.family, ref.shapes, ref.skips, ref.source)
    for cfg, rcfg in ((spec.model_cfg, ref.model_cfg),
                      (spec.smoke_cfg, ref.smoke_cfg)):
        for f in ("name", "n_layer", "d_model", "n_head", "n_kv", "d_ff",
                  "vocab", "d_head", "rope_theta", "qkv_bias", "moe"):
            assert getattr(cfg, f) == getattr(rcfg, f), f
        assert cfg.param_count == rcfg.param_count
    for shape in spec.shapes:
        assert configs.model_flops(spec, shape) == \
            jax_configs.model_flops(ref, shape)
    assert spec.model_cfg.dtype == torch.bfloat16


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_model_cfg_and_model_flops_take_the_reference_arguments(
        arch, smoke):
    """``cell_model_cfg(smoke=)`` and ``model_flops(model_cfg=)`` on every
    shape return the reference's values."""
    spec, ref = configs.get(arch), jax_configs.get(arch)
    for shape in spec.shapes:
        cfg = configs.cell_model_cfg(spec, shape, smoke=smoke)
        rcfg = jax_configs.cell_model_cfg(ref, shape, smoke=smoke)
        assert cfg is (spec.smoke_cfg if smoke else spec.model_cfg)
        for f in ("name", "n_layer", "d_model", "n_head", "n_kv", "d_ff",
                  "vocab", "d_head"):
            assert getattr(cfg, f) == getattr(rcfg, f), f
        assert configs.model_flops(spec, shape, model_cfg=cfg) == \
            jax_configs.model_flops(ref, shape, model_cfg=rcfg)


def test_glm4_has_the_published_parameter_count():
    cfg = configs.get("glm4-9b").model_cfg
    assert cfg.param_count == 9_399_951_360 == \
        jax_configs.get("glm4-9b").model_cfg.active_param_count


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    jcfg, params, model = models(arch, dtype)
    toks = tokens(jcfg, 2, 16)
    want, want_aux = jax_tfm.forward(params, jcfg, jnp.asarray(toks))
    got, aux = tfm.forward(model, torch.as_tensor(toks))
    assert got.dtype == torch.float32 and float(aux) == float(want_aux) == 0
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, dtype):
    jcfg, params, model = models(arch, dtype, seed=2)
    B, S = 2, 8
    toks = tokens(jcfg, B, S, seed=3)
    jcache = jax_tfm.init_cache(jcfg, B, S + 3)
    cache = tfm.init_cache(model.cfg, B, S + 3, device="cpu")
    for i in range(S):
        want, jcache = jax_tfm.decode_step(params, jcfg,
                                           jnp.asarray(toks[:, i:i + 1]),
                                           jcache, jnp.int32(i))
        got, cache2 = tfm.decode_step(model, torch.as_tensor(toks[:, i:i + 1]),
                                      cache, i)
        assert cache2 is cache                   # updated in place
        close(got, want, dtype)
    close(cache["k"].float(), np.asarray(jcache["k"], np.float32), dtype)
    close(cache["v"].float(), np.asarray(jcache["v"], np.float32), dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_cache_decode_matches_reference(arch):
    """A bf16 model over an f32 cache (``init_cache(dtype=float32)``, the
    reference's ``init_cache(..., dtype=jnp.float32)``): q is attended in
    the cache's f32 (the reference's einsum promotes it), the attention's
    f32 output goes into wo, the residual stays bf16. Logits within the
    bf16 tolerance of the reference's decode; the caches hold the same
    values in f32."""
    jcfg, params, model = models(arch, "bf16", seed=4)
    B, S = 2, 8
    toks = tokens(jcfg, B, S, seed=5)
    jcache = jax_tfm.init_cache(jcfg, B, S + 3, dtype=jnp.float32)
    cache = tfm.init_cache(model.cfg, B, S + 3, dtype=torch.float32,
                           device="cpu")
    assert cache["k"].dtype == cache["v"].dtype == torch.float32
    for i in range(S):
        want, jcache = jax_tfm.decode_step(params, jcfg,
                                           jnp.asarray(toks[:, i:i + 1]),
                                           jcache, jnp.int32(i))
        got, _ = tfm.decode_step(model, torch.as_tensor(toks[:, i:i + 1]),
                                 cache, i)
        assert got.dtype == torch.float32
        close(got, want, "bf16")
    assert jcache["k"].dtype == jnp.float32
    close(cache["k"], np.asarray(jcache["k"]), "bf16")
    close(cache["v"], np.asarray(jcache["v"]), "bf16")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Greedy decode over a prefix reproduces the teacher-forced logits
    (tests/test_models.py::test_decode_matches_forward, in the port)."""
    cfg = dataclasses.replace(configs.get(arch).smoke_cfg,
                              dtype=torch.float32)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    B, S = 2, 8
    toks = torch.as_tensor(tokens(cfg, B, S))
    full, _ = tfm.forward(model, toks)
    cache = tfm.init_cache(cfg, B, 32, device="cpu")
    cache["k"].normal_()                # slots past cache_len are masked
    cache["v"].normal_()
    for i in range(S):
        step, _ = tfm.decode_step(model, toks[:, i:i + 1], cache, i)
        torch.testing.assert_close(step, full[:, i], rtol=2e-3, atol=2e-3)


def test_bf16_layer_rounds_as_the_reference_outside_attention():
    """Every bf16 step but the attention core is bit-identical to the
    reference's (so the bf16 tolerance above covers attention alone)."""
    jcfg, params, model = models("glm4-9b", "bf16")
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    p = model.layers[0]
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(2, 16, jcfg.d_model)), jnp.bfloat16)
    xt = torch.as_tensor(np.asarray(x, np.float32)).bfloat16()

    def same(a, b):
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())

    h, ht = jax_tfm.rms_norm(x, lp["ln1"]), tfm.rms_norm(xt, p.ln1)
    same(h, ht)
    same(h @ lp["wq"] + lp["bq"], tfm.linear(ht, p.wq) + p.bq)
    q = (h @ lp["wq"]).reshape(2, 16, jcfg.n_head, jcfg.d_head)
    pos = np.arange(16)[None]
    same(jax_tfm.rope(q, jnp.asarray(pos), jcfg.rope_theta),
         tfm.rope(tfm.linear(ht, p.wq).reshape(q.shape), torch.as_tensor(pos),
                  jcfg.rope_theta))
    same(jax_tfm.dense_ffn(lp["ffn"], h),
         p.ffn(ht, tfm.partition_of(model)))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps(arch):
    spec = configs.get(arch)
    cfg = dataclasses.replace(spec.smoke_cfg, dtype=torch.float32)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    toks = torch.as_tensor(tokens(cfg, 2, 6))
    before = (sm.matmul.launches, fa.flash_attention.launches)
    prefill = configs.make_serve_step(spec, "prefill_32k", cfg)
    logits = prefill(model, {"tokens": toks})
    assert logits.shape == (2, 6, cfg.vocab)
    decode = configs.make_serve_step(spec, "decode_32k", cfg)
    cache = tfm.init_cache(cfg, 2, 16, device="cpu")
    for i in range(6):
        step, cache = decode(model, {"tokens": toks[:, i:i + 1],
                                     "cache": cache, "cache_len": i})
        torch.testing.assert_close(step, logits[:, i], rtol=2e-3, atol=2e-3)
    assert (sm.matmul.launches, fa.flash_attention.launches) == before
    with pytest.raises(ValueError):                  # a model of another cfg
        prefill(tfm.init_params(spec.smoke_cfg, torch.Generator(),
                                device="cpu"), {"tokens": toks})
    with pytest.raises(NotImplementedError, match="make_train_step"):
        configs.make_serve_step(spec, "train_4k", cfg)


def test_moe_config_raises():
    """A MoE config builds a model and a serve step; a gnn
    spec whose config is no GNN config of the port (an LM config) still
    raises, naming A8."""
    moe = tfm.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16)
    cfg = tfm.LMConfig("m", n_layer=1, d_model=32, n_head=2, n_kv=2, d_ff=0,
                       vocab=64, d_head=16, moe=moe)
    spec = configs.ArchSpec(id="m", family="lm-moe", model_cfg=cfg,
                            smoke_cfg=cfg, shapes=configs.LM_SHAPES, skips={})
    assert configs.make_serve_step(spec, "prefill_32k")
    gnn = dataclasses.replace(spec, family="gnn")
    with pytest.raises(NotImplementedError, match="A8"):
        configs.cell_model_cfg(gnn, "prefill_32k")


def _jax_dtype(dtype) -> str:
    return np.dtype(dtype).name


def _torch_dtype(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _flatten_reference(tree, lm: bool) -> dict:
    """{port name: (shape, dtype name)} of a reference params tree of
    ShapeDtypeStructs: an LM's stacked layers split by layer (the names of
    ``core.carry.lm_params_from_reference``), a GNN's nested dicts and
    lists flattened into dotted names (``gnn_params_from_reference``'s)."""
    out = {}
    if lm:
        for name in ("embed", "head", "ln_f"):
            out[name] = (tuple(tree[name].shape), _jax_dtype(tree[name].dtype))

        def split(prefix, node):
            for k, v in node.items():
                if isinstance(v, dict):
                    split(f"{prefix}{k}.", v)
                    continue
                for i in range(v.shape[0]):
                    out[f"layers.{i}.{prefix}{k}"] = (tuple(v.shape[1:]),
                                                      _jax_dtype(v.dtype))
        split("", tree["layers"])
        return out
    def walk(prefix, node):
        if isinstance(node, (dict, list)):
            items = node.items() if isinstance(node, dict) else enumerate(node)
            for k, v in items:
                walk(f"{prefix}{k}.", v)
        else:
            out[prefix[:-1]] = (tuple(node.shape), _jax_dtype(node.dtype))
    walk("", tree)
    return out


def _port_shapes(tensors: dict) -> dict:
    return {n: (tuple(t.shape), _torch_dtype(t.dtype))
            for n, t in tensors.items()}


def test_all_cells_are_the_references_of_the_ported_archs():
    ported = set(configs.REGISTRY)
    for skipped in (False, True):
        want = [c for c in jax_configs.all_cells(include_skipped=skipped)
                if c[0] in ported]
        assert list(configs.all_cells(include_skipped=skipped)) == want
    assert ported == {"dbrx-132b", "qwen2-moe-a2.7b", "glm4-9b",
                      "codeqwen1.5-7b", "qwen1.5-110b", "meshgraphnet",
                      "nequip", "graphsage-reddit", "mace", "mind"}
    assert ported == set(jax_configs.REGISTRY)


@pytest.mark.parametrize(
    "arch,shape", list(configs.all_cells(include_skipped=True)),
    ids=[f"{a}-{s}" for a, s in configs.all_cells(include_skipped=True)])
def test_input_specs_match_the_reference(arch, shape):
    """Every ported cell's inputs at full size, on the meta device: the
    reference's ``input_specs`` in shape and dtype, name for name (the
    decode cache's k and v too)."""
    spec, ref = configs.get(arch), jax_configs.get(arch)
    got = configs.input_specs(spec, shape)
    want = jax_configs.input_specs(ref, shape)
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if isinstance(w, dict):                       # the decode cache
            assert g.keys() == w.keys()
            pairs = [(g[k], w[k]) for k in w]
        else:
            pairs = [(g, w)]
        for gt, wt in pairs:
            assert gt.device.type == "meta"
            assert (tuple(gt.shape), _torch_dtype(gt.dtype)) == \
                (tuple(wt.shape), _jax_dtype(wt.dtype)), name


@pytest.mark.parametrize("arch", sorted(
    {a for a, _ in configs.all_cells(include_skipped=True)}))
def test_abstract_params_match_the_references_eval_shape(arch):
    """``abstract_params`` of every ported architecture at full size (its
    first cell's config), on the meta device: every parameter of the
    reference's ``jax.eval_shape`` of its init, same name, shape and
    dtype, nothing allocated."""
    spec, ref = configs.get(arch), jax_configs.get(arch)
    shape = next(iter(spec.shapes))
    cfg = configs.cell_model_cfg(spec, shape)
    model = configs.abstract_params(spec, cfg)
    assert all(p.device.type == "meta" for p in model.parameters())
    tree = jax_configs.abstract_params(ref, jax_configs.cell_model_cfg(
        ref, shape))
    lm = spec.family.startswith("lm")
    assert _port_shapes(dict(model.named_parameters())) == \
        _flatten_reference(tree, lm)
    if lm:
        cache = tfm.abstract_cache(cfg, 2, 64)
        want = jax_tfm.abstract_cache(ref.model_cfg, 2, 64)
        assert _port_shapes(cache) == {
            k: (tuple(v.shape), _jax_dtype(v.dtype)) for k, v in want.items()}


def test_spec_surface_raises_for_unported_families():
    """``input_specs`` and ``abstract_params`` of a recsys spec whose config
    is not the port's MINDConfig (here an LM's) raise, naming MIND, and of
    a gnn spec whose config type the port does not know, naming A8; mind's
    own spec gives its meta tensors."""
    cfg = configs.get("glm4-9b").model_cfg
    for spec, match in (
            (configs.ArchSpec(id="r", family="recsys", model_cfg=cfg,
                              smoke_cfg=cfg, shapes=configs.RECSYS_SHAPES,
                              skips={}), "is MIND"),
            (configs.ArchSpec(id="mgn", family="gnn", model_cfg=object(),
                              smoke_cfg=object(), shapes=configs.GNN_SHAPES,
                              skips={}), "A8")):
        shape = next(iter(spec.shapes))
        with pytest.raises(NotImplementedError, match=match):
            configs.input_specs(spec, shape, model_cfg=spec.model_cfg)
        with pytest.raises(NotImplementedError, match=match):
            configs.abstract_params(spec, spec.model_cfg)
    mind = configs.get("mind")
    model = configs.abstract_params(mind, mind.model_cfg)
    assert model.item_embed.device.type == "meta"
    assert configs.input_specs(mind, "serve_bulk")["cand_ids"].shape == (
        262_144, 100)


def test_decode_step_rejects_bad_positions():
    cfg = configs.get("glm4-9b").smoke_cfg
    model = tfm.init_params(cfg, torch.Generator(), device="cpu")
    cache = tfm.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError):
        tfm.decode_step(model, torch.zeros(1, 1, dtype=torch.long), cache, 4)
    with pytest.raises(ValueError):
        tfm.decode_step(model, torch.zeros(1, 2, dtype=torch.long), cache, 0)


def test_carry_keeps_dtypes_and_names():
    jcfg, params, _ = models("glm4-9b", "bf16")
    tree = jax.tree.map(np.asarray, params)
    assert tree["embed"].dtype.name == "bfloat16"        # ml_dtypes
    state = lm_params_from_reference(tree)
    assert state["embed"].dtype == torch.bfloat16
    assert state["layers.1.ln1"].dtype == torch.float32
    assert np.array_equal(state["layers.1.ffn.wi"].float().numpy(),
                          np.asarray(params["layers"]["ffn"]["wi"][1],
                                     np.float32))
    as_f32 = lm_params_from_reference(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params))
    assert as_f32["embed"].dtype == torch.float32
    assert set(state) == set(tfm.Transformer(
        configs.get("glm4-9b").smoke_cfg, device="meta").state_dict())


def test_bf16_decode_matches_forward_at_full_depth():
    """A glm4-shaped model at glm4's depth (40 layers, GQA 16:1, QKV bias)
    but narrow widths, in bf16: decode over a prefix, with random values in
    the cache's masked slots, holds each step within 5e-2 of the largest
    |logit| of the prefill's logits at that position. This is the bound of
    chip_smoke.py's full-width decode-vs-prefill check: the two paths
    differ only in summation order (other tiles, other splits), and 40
    layers of bf16 roundings decorrelate."""
    cfg = tfm.LMConfig("glm4-narrow", n_layer=40, d_model=256, n_head=16,
                       n_kv=1, d_ff=768, vocab=4096, d_head=16,
                       qkv_bias=True)
    gen = torch.Generator().manual_seed(5)
    model = tfm.init_params(cfg, gen, device="cpu")
    toks = torch.randint(0, cfg.vocab, (4, 12), generator=gen)
    full, _ = tfm.forward(model, toks)
    cache = tfm.init_cache(cfg, 4, 64, device="cpu")
    cache["k"].normal_(generator=gen)
    cache["v"].normal_(generator=gen)
    for i in range(toks.shape[1]):
        step, _ = tfm.decode_step(model, toks[:, i:i + 1], cache, i)
        want = full[:, i]
        assert (step - want).abs().max() <= 5e-2 * want.abs().max()
