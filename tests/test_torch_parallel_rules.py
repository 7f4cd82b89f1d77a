"""The port's partition plan against the JAX package's, and what a mesh
refuses.

Rules: for every parameter of the tiny model of `tests/test_training_step.py`
and of parler-tts-mini-v1 (shapes only: the port's model on the meta device,
JAX's through `jax.eval_shape`), `params_shardings` and
`fsdp_params_shardings` of `parler_tts_tpu_torch/parallel/mesh.py` give the
`PartitionSpec` that the JAX package's give, on the meshes (data, model) =
(2, 1), (1, 2), (2, 2) and (1, 4) of the session's 8 virtual CPU devices.

Refusals (two gloo ranks of `tests/torch_dist_worker.py`): a `seq` axis
(ROADMAP item 23b), tensor parallelism with int8 weights or fused q|k|v
(23c), a mesh whose size is not the world; and, with no process group, a
decoder embedding the model axis would shard and the fused decode step of
a model sharded over heads (23c).
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
    cfg = port_config(dataclasses.replace(tiny_config(), decoder=dataclasses.replace(
        tiny_config().decoder, dropout=0.0)))
    got = launch(2, "refusals", {"cfg": cfg})
    assert got[0] == got[1]
    errors = got[0]
    assert errors["n_seq"].startswith("NotImplementedError") and "23b" in errors["n_seq"]
    assert errors["mesh_world"].startswith("ValueError") and "3x1x1 != 2" in errors["mesh_world"]
    for case in ("weight_quant", "fused_qkv"):
        assert errors[case].startswith("NotImplementedError") and "23c" in errors[case], case


def test_a_vocab_sharded_decoder_embedding_is_refused():
    """Where the model axis divides vocab+1, the rules shard `embed_tokens`
    over vocab (as JAX's do); the port keeps that table whole and refuses
    such a model (23c) rather than compute it otherwise."""
    cfg = port_config(tiny_config())
    even = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, vocab_size=cfg.decoder.vocab_size + 1))
    sizes = {"data": 1, "seq": 1, "model": 2}
    for c, sharded in ((cfg, False), (even, True)):
        model = ParlerTTS(c, device="meta")
        plan = params_shardings({n: tuple(p.shape) for n, p in model.named_parameters()}, sizes)
        assert any(plan["decoder.decoder.embed_tokens"]) == sharded
        if sharded:
            with pytest.raises(NotImplementedError, match="embed_tokens.*23c"):
                check_model_axis(model, 2)
        else:
            check_model_axis(model, 2)


def test_fused_decode_refuses_a_tensor_parallel_model():
    cfg = port_config(tiny_config())
    model = ParlerTTS(cfg, device="meta")
    model.mesh = type("M", (), {"model": Shard(None, 2, 0)})()
    gen = tc.GenerationConfig(max_length=8, bos_token_id=cfg.decoder.bos_token_id,
                              pad_token_id=cfg.decoder.pad_token_id,
                              eos_token_id=cfg.decoder.eos_token_id)
    ids = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="23c"):
        generate_tokens_fused(model, gen, None, ids, None, ids, None)
    np.testing.assert_equal(model.model_shards, 2)
