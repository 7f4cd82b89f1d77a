"""Tensor parallelism with the weights the JAX package serves that way: int8
weights (`weight_quant=True`, kernel K2's plain version on the CPU, and
`weight_quant="xla"`, the plain-matmul form), the
fused q|k|v projection (`fused_qkv=True`) and a decoder whose embedding rows
the model axis divides (sharded over vocab, as the JAX rule does). On the
CPU, fp32 cache, on the tiny config of `tests/test_torch_pipeline.py`.

  * TP=2 over two gloo ranks (`tests/torch_dist_worker.py`): greedy
    `make_generate(mesh=)` at B=2 and `make_generate_speculative(mesh=)`
    (window 4) at B=1, each rank's delayed ids equal to JAX's
    `make_generate(mesh=)` / `make_generate_speculative(mesh=)` over a
    (1, 1, 2) mesh of the session's virtual CPU devices, on the same tree;
    each rank holds half of every split leaf, and the tree gathered from the
    ranks' shards is the full tree;
  * quantization commutes with the split: a rank's columns of the int8
    kernel and its scales are the quantization of its columns of the float
    kernel (the scales are per output column over the whole input dim), and
    a row-parallel rank's rows keep the whole scale;
  * the plan: int8 leaves split as their float kernels, the fused kernel by
    each of its q, k and v parts; int8 weights with fused q|k|v stay refused
    under a model axis, as the JAX pipeline refuses the pair.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.models.parler import ParlerTTS as JParler
from parler_tts_tpu.models.parler import fuse_qkv_params as jax_fuse_qkv
from parler_tts_tpu.parallel import make_mesh as jax_mesh
from parler_tts_tpu.parallel import shard_params as jax_shard_params
from parler_tts_tpu.runtime.generate import make_generate as jax_generate
from parler_tts_tpu.runtime.speculative import make_generate_speculative as jax_speculative
from parler_tts_tpu.utils.quantize import quantize_decoder_params
from parler_tts_tpu_torch.models.parler import ParlerTTS
from parler_tts_tpu_torch.parallel import params_shardings
from parler_tts_tpu_torch.parallel.collectives import Shard
from parler_tts_tpu_torch.parallel.mesh import (
    check_model_axis,
    local_part,
    param_partition_spec,
    spec_axes,
)
from parler_tts_tpu_torch.utils.quantize import quantize_kernel_torch
from test_torch_models import host, port_config
from test_torch_parallel_generate import TGEN, request, rows
from test_torch_pipeline import CFG, GEN
from test_torch_training import flat
from torch_dist_worker import launch

WINDOW = 4
EVEN = dataclasses.replace(CFG, decoder=dataclasses.replace(CFG.decoder, vocab_size=101))
MODES = {  # name: (config, model arguments, how the float tree becomes the model's)
    "int8": (CFG, dict(weight_quant=True), quantize_decoder_params),
    "int8 xla": (CFG, dict(weight_quant="xla"), quantize_decoder_params),
    "fused_qkv": (CFG, dict(fused_qkv=True), lambda p: host(jax_fuse_qkv(p))),
    "vocab-sharded embedding": (EVEN, {}, lambda p: p),
}


def jax_tree(cfg):
    params = jax.jit(JParler(cfg).init)(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
        jnp.zeros((1, 3), jnp.int32), jnp.ones((1, 3), jnp.int32),
        jnp.zeros((1, 2, cfg.decoder.num_codebooks), jnp.int32))["params"]
    return host(params)


@pytest.fixture(scope="module")
def runs():
    mesh = jax_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    req = rows(request(), 2)
    want, cases, trees = {}, [], {}
    for name, (cfg, kw, convert) in MODES.items():
        tree = convert(jax_tree(cfg))
        trees[name] = tree
        jm = JParler(cfg, use_flash_decode=True, **kw)
        sharded = jax_shard_params(tree, mesh)
        want[name] = np.asarray(jax_generate(jm, GEN, cache_dtype=jnp.float32, mesh=mesh)(
            sharded, *req, jax.random.key(0)).delayed_ids)
        want[f"{name} speculative"] = np.asarray(jax_speculative(
            jm, GEN, window=WINDOW, cache_dtype=jnp.float32, mesh=mesh)(
            sharded, *rows(req, 1), jax.random.key(0))[0].delayed_ids)
        case = dict(mesh=(1, 2), cfg=port_config(cfg), model_kw=kw, params=tree, gen=TGEN)
        cases += [dict(case, name=name, inputs=req, tree=True),
                  dict(case, name=f"{name} speculative", inputs=rows(req, 1), window=WINDOW)]
    got = {}
    for res in launch(2, "generate", {"cfg": port_config(CFG), "params": trees["int8"],
                                      "cases": cases}):
        for name, out in res.items():
            got.setdefault(name, []).append(out)
    return want, got, trees


@pytest.mark.parametrize("name", [f"{m}{s}" for m in MODES for s in ("", " speculative")])
def test_tensor_parallel_generation_equals_jax(runs, name):
    want, got, _ = runs
    assert len(got[name]) == 2
    for out in got[name]:  # every rank holds the global result
        np.testing.assert_array_equal(out["delayed"], want[name])
        assert out["steps"] == GEN.max_length
        if name.endswith("speculative"):
            forwards, columns, _ = out["stats"]
            assert 0 < forwards < columns


@pytest.mark.parametrize("name", list(MODES))
def test_each_rank_holds_its_half_and_the_gathered_tree_is_whole(runs, name):
    _, got, trees = runs
    cfg, kw, _ = MODES[name]
    full = {n: tuple(p.shape) for n, p in ParlerTTS(port_config(cfg), device="meta",
                                                    **kw).named_parameters()}
    plan = params_shardings(full, {"data": 1, "seq": 1, "model": 2})
    want = flat(trees[name])
    halved = set()
    for out in got[name]:
        for n, shape in out["shapes"].items():
            assert shape == tuple(s // 2 if a == "model" else s
                                  for s, a in zip(full[n], spec_axes(plan[n]))), n
            if shape != full[n]:
                halved.add(n.rsplit(".", 1)[-1] if "layers" in n else n)
        tree = flat(out["tree"])
        assert tree.keys() == want.keys()
        for n, w in want.items():
            np.testing.assert_array_equal(tree[n], w, err_msg=n)
    expect = {"int8": {"w_q", "scale"}, "int8 xla": {"w_q", "scale"}, "fused_qkv": {"kernel"},
              "vocab-sharded embedding": {"decoder.decoder.embed_tokens"}}[name]
    assert expect <= halved, halved


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("split", ["columns", "rows"])
def test_int8_split_commutes_with_quantization(n_model, split):
    """Column-parallel (q/k/v, fc1): rank r's w_q and scale columns are the
    quantization of its float columns, bit for bit. Row-parallel (out_proj,
    fc2): rank r's w_q rows with the whole scale are the whole int8
    kernel's rows, and its partial products sum to the whole product."""
    g = torch.Generator().manual_seed(n_model)
    w = torch.randn(64, 96, generator=g) * 0.05
    w_q, scale = quantize_kernel_torch(w)
    x = torch.randn(3, 64, generator=g)
    parts = []
    for r in range(n_model):
        shard = Shard(None, n_model, r)
        if split == "columns":
            cols = shard.span(96)
            mine_q, mine_s = quantize_kernel_torch(w[:, cols])
            assert torch.equal(mine_q, w_q[:, cols]) and torch.equal(mine_s, scale[cols])
        else:
            rows_ = shard.span(64)
            parts.append((x[:, rows_].double() @ w_q[rows_].double()) * scale.double())
    if split == "rows":
        whole = (x.double() @ w_q.double()) * scale.double()
        torch.testing.assert_close(sum(parts), whole, rtol=1e-12, atol=1e-12)


def test_the_plan_splits_int8_and_fused_leaves_as_their_kernels():
    sizes = {"data": 1, "seq": 1, "model": 2}
    q8 = params_shardings(ParlerTTS(port_config(CFG), device="meta", weight_quant=True), sizes)
    layer = "decoder.decoder.layers.0."
    for proj in ("self_attn.q_proj", "self_attn.k_proj", "encoder_attn.v_proj", "fc1"):
        assert q8[f"{layer}{proj}.w_q"] == (None, "model")
        assert q8[f"{layer}{proj}.scale"] == ("model",)
    for proj in ("self_attn.out_proj", "encoder_attn.out_proj", "fc2"):
        assert q8[f"{layer}{proj}.w_q"] == ("model", None)
        assert q8[f"{layer}{proj}.scale"] == (None,)
    fused = params_shardings(ParlerTTS(port_config(CFG), device="meta", fused_qkv=True), sizes)
    entry = fused[f"{layer}self_attn.qkv_proj.kernel"][1]
    d = CFG.decoder.hidden_size
    kv = CFG.decoder.num_key_value_heads * CFG.decoder.head_dim
    assert entry == ("model", (d, kv, kv))
    with pytest.raises(ValueError, match="needs its shape"):
        param_partition_spec(f"{layer}self_attn.qkv_proj.kernel")
    # a rank's part holds its q, k and v heads side by side
    kernel = torch.arange(d + 2 * kv, dtype=torch.float32)[None].expand(3, -1)
    for r in range(2):
        mesh = type("M", (), {"axis": staticmethod(lambda a, r=r: Shard(None, 2, r))})()
        got = local_part(kernel, (None, entry), mesh)[0]
        want = torch.cat([torch.arange(start + r * w // 2, start + (r + 1) * w // 2)
                          for start, w in ((0, d), (d, kv), (d + kv, kv))]).float()
        assert torch.equal(got, want)


def test_check_model_axis_takes_what_jax_serves_and_refuses_the_rest():
    for cfg, kw in ((CFG, dict(weight_quant=True)), (CFG, dict(weight_quant="xla")),
                    (CFG, dict(fused_qkv=True)), (EVEN, {})):
        check_model_axis(ParlerTTS(port_config(cfg), device="meta", **kw), 2)
    with pytest.raises(ValueError, match="fused_qkv does not support weight_quant"):
        check_model_axis(ParlerTTS(port_config(CFG), device="meta", weight_quant=True,
                                   fused_qkv=True), 2)
    with pytest.raises(ValueError, match="does not divide"):
        check_model_axis(ParlerTTS(port_config(CFG), device="meta", weight_quant=True), 3)
