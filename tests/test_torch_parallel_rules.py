"""The port's partition plan against the JAX package's, and what a mesh
refuses.

Rules: for every parameter of the tiny model of `tests/test_training_step.py`
and of parler-tts-mini-v1 (shapes only: the port's model on the meta device,
JAX's through `jax.eval_shape`), `params_shardings` and
`fsdp_params_shardings` of `parler_tts_tpu_torch/parallel/mesh.py` give the
`PartitionSpec` that the JAX package's give, on the meshes (data, model) =
(2, 1), (1, 2), (2, 2) and (1, 4) of the session's 8 virtual CPU devices.

What a mesh takes and refuses (two gloo ranks of
`tests/torch_dist_worker.py`): a `seq` axis builds a (1, 2, 1) mesh, tensor
parallelism shards int8 and fused q|k|v models, a mesh whose size is not
the world is refused; and, with no process group, a decoder embedding the
model axis divides is planned sharded over vocab and taken, and the fused
decode step refuses a model sharded over heads (the JAX fused path takes no
mesh). The test names are kept from when these were refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu import config as jc
from parler_tts_tpu.models.parler import ParlerTTS as JParler
from parler_tts_tpu.parallel import make_mesh as jax_mesh
from parler_tts_tpu.parallel.mesh import fsdp_params_shardings as jax_fsdp
from parler_tts_tpu.parallel.mesh import params_shardings as jax_plan
from parler_tts_tpu_torch import config as tc
from parler_tts_tpu_torch.models.parler import ParlerTTS
from parler_tts_tpu_torch.parallel import fsdp_params_shardings, params_shardings
from parler_tts_tpu_torch.parallel.collectives import Shard
from parler_tts_tpu_torch.parallel.mesh import check_model_axis, flax_path
from parler_tts_tpu_torch.runtime.generate import generate_tokens_fused
from test_torch_models import port_config
from test_training_step import tiny_config
from torch_dist_worker import launch

MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]


def jax_shapes(cfg):
    model = JParler(cfg)
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
        jnp.zeros((1, 3), jnp.int32), jnp.ones((1, 3), jnp.int32),
        jnp.zeros((1, 2, cfg.decoder.num_codebooks), jnp.int32))["params"]
    return shapes


def specs_by_path(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
            for path, s in flat}


CONFIGS = {
    "tiny": lambda: tiny_config(),
    "mini_v1": lambda: jc.ParlerTTSConfig.from_json(tc.mini_v1_config().to_json()),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_partition_plan_equals_jax(name):
    cfg = CONFIGS[name]()
    shapes = jax_shapes(cfg)
    port = ParlerTTS(port_config(cfg), device="meta")
    named = {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert len(named) == len(jax.tree.leaves(shapes))
    checked = 0
    for n_data, n_model in MESHES:
        mesh = jax_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[:n_data * n_model])
        sizes = {"data": n_data, "seq": 1, "model": n_model}
        for fn, jfn in ((params_shardings, jax_plan), (fsdp_params_shardings, jax_fsdp)):
            want = specs_by_path(jfn(shapes, mesh))
            got = {flax_path(n): spec for n, spec in fn(named, sizes).items()}
            assert got.keys() == want.keys()
            for path, spec in got.items():
                assert spec == want[path], (name, n_data, n_model, fn.__name__, path)
                checked += any(spec)
    # the rules shard something on every mesh and every plan
    assert checked > 8 * len(MESHES)


def test_refusals_name_what_they_lack():
    """A seq axis and tensor parallelism over int8 or fused q|k|v weights
    are taken (each rank reports its mesh or the shards it holds); a mesh
    that is not the world is refused."""
    cfg = port_config(dataclasses.replace(tiny_config(), decoder=dataclasses.replace(
        tiny_config().decoder, dropout=0.0)))
    got = launch(2, "refusals", {"cfg": cfg})
    errors = got[0]
    assert errors["n_seq"] == "no error: {'data': 1, 'seq': 2, 'model': 1}"
    assert [r["seq_rank"] for r in got] == [0, 1]
    assert errors["mesh_world"].startswith("ValueError") and "3x1x1 != 2" in errors["mesh_world"]
    layer = "decoder.decoder.layers.0.self_attn."
    d = cfg.decoder.hidden_size
    kv = cfg.decoder.num_key_value_heads * cfg.decoder.head_dim
    for r in got:
        assert r["weight_quant"] == f"no error: {layer}q_proj.w_q {(d, d // 2)}"
        assert r["fused_qkv"] == f"no error: {layer}qkv_proj.kernel {(d, (d + 2 * kv) // 2)}"


def test_a_vocab_sharded_decoder_embedding_is_refused():
    """Where the model axis divides vocab+1, the rules shard `embed_tokens`
    over vocab (as JAX's do), and the port takes such a model: each
    codebook's lookup is vocab-parallel (`models/decoder.py:embed_ids`,
    held against JAX in `tests/test_torch_parallel_quant.py`)."""
    cfg = port_config(tiny_config())
    even = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, vocab_size=cfg.decoder.vocab_size + 1))
    sizes = {"data": 1, "seq": 1, "model": 2}
    for c, sharded in ((cfg, False), (even, True)):
        model = ParlerTTS(c, device="meta")
        plan = params_shardings({n: tuple(p.shape) for n, p in model.named_parameters()}, sizes)
        assert plan["decoder.decoder.embed_tokens"] == ((None, "model", None) if sharded
                                                        else (None, None, None))
        check_model_axis(model, 2)


def test_fused_decode_refuses_a_tensor_parallel_model():
    cfg = port_config(tiny_config())
    model = ParlerTTS(cfg, device="meta")
    model.mesh = type("M", (), {"model": Shard(None, 2, 0)})()
    gen = tc.GenerationConfig(max_length=8, bos_token_id=cfg.decoder.bos_token_id,
                              pad_token_id=cfg.decoder.pad_token_id,
                              eos_token_id=cfg.decoder.eos_token_id)
    ids = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="takes no mesh, as the JAX package's fused"):
        generate_tokens_fused(model, gen, None, ids, None, ids, None)
    np.testing.assert_equal(model.model_shards, 2)
