"""Ranks of the port's parallel tests: torch and the port only, never JAX.

`launch(world, task, payload)` runs `python tests/torch_dist_worker.py` once
per rank, on the CPU over gloo (torchrun's environment: RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), hands every rank the pickled
`payload`, and returns each rank's pickled result. The ranks are killed and
the launch fails after `timeout` seconds, so a collective that deadlocks
fails one test. The test process computes the JAX references and compares.

Tasks:
  generate  - `make_generate` / `make_generate_speculative` over a mesh per
              case: delayed ids, steps and SpecStats;
  train     - `make_train_step` over a mesh per case: per-step metrics and
              the full parameters after the last step;
  cli       - `run_training` at the launched world, then evaluations;
  seq_shift - a seq-parallel teacher-forced forward: each rank's shifted
              inputs and its partial loss sums ("seq shift");
  refusals  - what a mesh takes or refuses, each error's text;
  many      - several of these in one process group, their results merged.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, task: str, payload, timeout: float = 120.0):
    """Each rank's result of `task` over `payload`, in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        port = str(_free_port())
        procs = []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="1",
                       PYTHONPATH=str(ROOT))
            procs.append(subprocess.Popen(
                [sys.executable, __file__, tmp, task], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise AssertionError(f"{task} at world {world}: ranks did not finish in "
                                 f"{timeout} s")
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"{task} rank {rank} exited {p.returncode}:\n{log[-4000:]}")
        out = []
        for rank in range(world):
            with open(os.path.join(tmp, f"result-{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ------------------------------------------------------------------ ranks
def _port_model(cfg, params, **kw):
    from parler_tts_tpu_torch.convert import load_jax_params
    from parler_tts_tpu_torch.models.parler import ParlerTTS

    model = ParlerTTS(cfg, device="cpu", **kw)
    load_jax_params(model, params)
    return model


def task_generate(payload):
    """One model per case, sharded on the case's mesh, the global request
    on every rank, on the payload's `device` (default the CPU; "cuda" puts
    every rank's tensors on the card, gloo carrying them through the host).
    A case may bring its own `cfg`, `params` and `model_kw` (weight_quant,
    fused_qkv), and with `tree` returns the model's full tree gathered from
    the ranks' shards."""
    import torch

    from parler_tts_tpu_torch.convert import load_jax_params, to_jax_tree
    from parler_tts_tpu_torch.models.parler import ParlerTTS
    from parler_tts_tpu_torch.parallel import make_mesh, shard_params
    from parler_tts_tpu_torch.runtime.generate import make_generate
    from parler_tts_tpu_torch.runtime.speculative import make_generate_speculative

    dev = torch.device(payload.get("device", "cpu"))
    out = {}
    for case in payload["cases"]:
        mesh = make_mesh(*case["mesh"], device=dev)
        model = ParlerTTS(case.get("cfg", payload["cfg"]), device=dev, **case.get("model_kw", {}))
        shard_params(model, mesh)
        load_jax_params(model, case.get("params", payload["params"]))  # each rank its shards
        if case.get("window"):
            fn = make_generate_speculative(model, case["gen"], window=case["window"],
                                           cache_dtype=torch.float32,
                                           per_row=case.get("per_row", False),
                                           lookup_ngram=case.get("lookup", 3), mesh=mesh)
        else:
            fn = make_generate(model, case["gen"], torch.float32, mesh=mesh)
        seed = case.get("seed")
        generator = None if seed is None else torch.Generator(dev).manual_seed(seed)
        res = fn(*(torch.from_numpy(x).to(dev) for x in case["inputs"]), generator=generator)
        gen_out, stats = (res[0], tuple(res[1])) if case.get("window") else (res, None)
        out[case["name"]] = dict(delayed=gen_out.delayed_ids.cpu().numpy(), steps=gen_out.steps,
                                 stats=stats, shapes={n: tuple(p.shape) for n, p in
                                                      model.named_parameters()})
        if case.get("tree"):
            out[case["name"]]["tree"] = to_jax_tree(model.named_parameters(), model=model)
    return out


def task_train(payload):
    """`steps` train steps per case from the same full tree, each rank fed
    its data share of every global batch and its seq share of the label
    columns (a case's `mesh` is (n_data, n_model[, n_seq])), on the
    payload's `device` (default the CPU); each case also reports the K4
    launches of its steps on this rank."""
    import torch

    from parler_tts_tpu_torch.convert import to_jax_tree
    from parler_tts_tpu_torch.ops.flash_attention import flash_attention
    from parler_tts_tpu_torch.parallel import local_batch_slice, local_seq_slice, make_mesh
    from parler_tts_tpu_torch.training import Batch, TrainState, make_optimizer, make_train_step
    from parler_tts_tpu_torch.training.train_state import shard_train_state

    dev = torch.device(payload.get("device", "cpu"))
    out = {}
    for case in payload["cases"]:
        mesh = make_mesh(*case["mesh"], device=dev)
        model = _port_model(case.get("cfg", payload["cfg"]), payload["params"],
                            **case.get("model_kw", {})).to(dev)
        tx = make_optimizer(**payload["opt"])
        state = shard_train_state(TrainState.create(model, tx), mesh, fsdp=case.get("fsdp", False))
        step = make_train_step(model, tx, mesh=mesh, loss_chunk_size=case.get("chunk"),
                               microbatch_steps=case.get("micro"))
        before = dict(flash_attention.launches)
        metrics = []
        for i, arrays in enumerate(payload["batches"]):
            rows = local_batch_slice(arrays[0].shape[0], mesh.data.rank, mesh.data.size)
            cols = local_seq_slice(arrays[-1].shape[1], mesh)
            batch = Batch(*(torch.from_numpy(x[rows]).to(dev) for x in arrays[:-1]),
                          torch.from_numpy(arrays[-1][rows, cols]).to(dev))
            state, m = step(state, batch, payload.get("seed", 0) + i)
            metrics.append({k: v.detach().cpu().numpy().copy() for k, v in m.items()})
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        out[case["name"]] = dict(metrics=metrics, shapes=shapes,
                                 params=to_jax_tree(model.named_parameters(), model=model),
                                 k4={n: flash_attention.launches[n] - before[n] for n in before})
    return out


def task_cli(payload):
    """`run_training` at this world once per argument set (each its own
    output directory), then the trained state's eval loss and eval
    generation (`run_eval`, `run_eval_generation`) on every rank. Returns
    per run the logged train losses (rank 0), the step, the eval loss and
    the eval generation's delayed ids."""
    from parler_tts_tpu_torch.codec.registry import build_codec
    from parler_tts_tpu_torch.convert import load_jax_dac_params
    from parler_tts_tpu_torch.training import run_training as rt

    losses = []
    log = rt.log_metric

    def record(tracker, metrics, *a, prefix="train", **k):
        if prefix == "train":
            losses.append(float(metrics["loss"]))
        return log(tracker, metrics, *a, prefix=prefix, **k)

    rt.log_metric = record
    codes = []
    generate_codes = rt.ParlerTTSPipeline.generate_codes

    def recorded(self, *a, **k):
        out = generate_codes(self, *a, **k)
        codes.append(out.delayed_ids.numpy().copy())
        return out

    rt.ParlerTTSPipeline.generate_codes = recorded
    codec = build_codec(payload["cfg"].audio_encoder)
    load_jax_dac_params(codec, payload["dac_params"])
    out = []
    for margs, dargs, targs in payload["runs"]:
        del losses[:], codes[:]
        model = _port_model(payload["cfg"], payload["params"], use_chunked_attention=True)
        state, step = rt.run_training(margs, dargs, targs, model, payload["features"],
                                      device="cpu")
        collator = rt.DataCollatorParlerTTSWithPadding(
            prompt_padding_side=margs.prompt_padding_side,
            max_total_length=payload["cfg"].decoder.max_position_embeddings)
        eval_loss = rt.run_eval(state, collator, payload["eval_features"], targs, None, step, 0)
        rt.run_eval_generation(state, codec, payload["eval_features"], margs, targs, None,
                               step, 0, max_samples=2)
        out.append(dict(losses=list(losses), step=step, eval_loss=eval_loss,
                        codes=codes[0], shards={n: tuple(p.shape) for n, p in
                                                state.model.named_parameters()}))
    return out


def task_seq_shift(payload):
    """Over a (1, 1, world) mesh, one deterministic teacher-forced forward
    per batch: the rank's shifted decoder inputs and its own (unsummed)
    loss sum and token count."""
    import torch

    from parler_tts_tpu_torch.ops.losses import per_codebook_cross_entropy
    from parler_tts_tpu_torch.parallel import local_seq_slice, make_mesh, shard_params

    mesh = make_mesh(1, 1, n_seq=payload["world"])
    model = shard_params(_port_model(payload["cfg"], payload["params"]), mesh)
    dcfg = payload["cfg"].decoder
    out = []
    with torch.no_grad():
        for arrays in payload["batches"]:
            cols = local_seq_slice(arrays[-1].shape[1], mesh)
            batch = [torch.from_numpy(x) for x in arrays[:-1]]
            labels = torch.from_numpy(arrays[-1][:, cols])
            logits, dec_ids = model(*batch, labels)
            loss, items, _, _ = per_codebook_cross_entropy(
                logits, labels, dec_ids, bos_token_id=dcfg.bos_token_id,
                eos_token_id=dcfg.eos_token_id)
            out.append(dict(dec_ids=dec_ids.numpy(), loss=float(loss), items=float(items)))
    return {"seq shift": out}


def task_many(payload):
    """Each (task, payload) of `payload["tasks"]` in turn, over one process
    group; their {case name: result} dicts merged."""
    out = {}
    for task, sub in payload["tasks"]:
        out.update(globals()[f"task_{task}"](sub))
    return out


def task_refusals(payload):
    """What a mesh refuses: each error (type name and text), or "no error"
    and what was built (the mesh's shape; a sharded model's first
    self-attention input projection and its shape on this rank)."""
    from parler_tts_tpu_torch.models.parler import ParlerTTS
    from parler_tts_tpu_torch.parallel import make_mesh, shard_params

    cfg = payload["cfg"]

    def attempt(fn):
        try:
            built = fn()
        except Exception as e:  # noqa: BLE001 - the test reads the error
            return f"{type(e).__name__}: {e}"
        return f"no error: {built}"

    def sharded(**kw):
        model = shard_params(ParlerTTS(cfg, device="cpu", **kw), make_mesh(1, 2))
        name, p = next((n, p) for n, p in model.named_parameters()
                       if ".self_attn." in n and n.endswith(("q_proj.w_q", "qkv_proj.kernel")))
        return f"{name} {tuple(p.shape)}"

    return {
        "n_seq": attempt(lambda: make_mesh(1, 1, n_seq=2).shape),
        "seq_rank": make_mesh(1, 1, n_seq=2).seq.rank,
        "mesh_world": attempt(lambda: make_mesh(3, 1)),
        "weight_quant": attempt(lambda: sharded(weight_quant=True)),
        "fused_qkv": attempt(lambda: sharded(fused_qkv=True)),
    }


def _main(tmp: str, task: str) -> None:
    import torch
    import torch.distributed as dist

    from parler_tts_tpu_torch.parallel import maybe_init_distributed

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, _ = maybe_init_distributed(device="cpu")  # gloo, also for CUDA tensors
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    result = globals()[f"task_{task}"](payload)
    with open(os.path.join(tmp, f"result-{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    # rank 0 serves the group's store: leaving before the others are done with it
    # breaks their pipe to it (a task may end with a rank still in a store call)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _main(*sys.argv[1:3])
