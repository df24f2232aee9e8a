"""One data-parallel rank of the port on the CPU, over gloo: the child the
data-parallel tests start ``world`` times (`tests/torch_dp.py`).

Usage: python torch_dp_worker.py <spec.pkl> <out_dir>

The environment gives RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT;
the spec (a pickled dict) gives ``cases``, run in order in one process
group, each a dict with a ``kind``:

- "train": ``initialize`` GPT-NeoX (``size``; ``weights``, a JAX params
  tree of numpy leaves, or else the port's own init from ``seed``) with
  ``conf`` (this rank's micro-batch), then
  ``steps`` steps on this rank's columns of ``tokens`` [gas, micro ·
  world, S] (the JAX engine's global batch split over its data axis),
  through `train_batch` or, with ``legacy``, the forward / backward /
  step loop. Optional: ``load`` (a checkpoint dir to resume from first;
  with ``wait_for``, a file to wait for before loading, written by the
  test process; the masters right after it are reported as
  ``loaded_master``; with ``load_error`` a refused load reports its
  message as ``load_error`` and ends the case), ``save`` (dir) and ``save_at`` (after that many steps;
  the last by default), ``inject_inf`` ({"step", "rank"}: an inf in that
  rank's reduced gradient at that step, 1-based), ``eval`` (the
  eval_batch loss of the first micro-batch after training), ``hook``
  (layer indices captured through `set_layers_to_hook` on the first
  step), ``edit`` ({"leaf", "value"}: a row of that leaf set through
  `gathered_parameters` before training), ``consolidated`` (the ZeRO-3
  consolidated state dict after training), ``mesh`` ("expert" or
  "data": a 1-D `DeviceMesh` over the ranks handed to `initialize`),
  ``master_file`` (rank 0 saves the fp32 masters there after training,
  whole and in the natural order, with `torch.save`).
  Reports the losses, each step's host ms (the returned loss syncs the
  device), the masters and the compute parameters (natural
  leaves, fp32, whole: gathered over the ranks), the loss scale, the
  counters, this rank's state bytes by buffer, the files this rank
  wrote and the collectives the case staged through the host
  (``light``: no masters or parameters).
- "csr": `csr_allreduce` of this rank's row-sparse ``dense[rank]``.
- "stage1": the standalone stage-1 / stage-2 optimizers on a few tensors.
- "loader": the `DeepSpeedDataLoader` order at the group's defaults.
- "refuse": `initialize` with each of ``confs`` (a name → config; a
  config may carry "model": "gpt2" for a tiny GPT-2); the message of the
  error each raises (None where none is raised).
- "zero_api": `zero.Init` / `GatheredParameters` standalone over the
  group: the local shapes, the gathered leaves and the write-back.
- "moe_fn": the MoE FFN on this rank's rows of ``x`` [T, H] (numpy):
  ``fn`` "dense" (`moe_ffn_dense` routing the global batch over the
  group, experts whole), "ep" (`moe_ffn_expert_parallel` over this
  rank's experts of ``params``) or "layer" (`MoELayer(mesh=)`), for each
  of ``runs`` (dicts of keyword arguments); reports y, aux, the
  gradients of sum(y · ``w``'s rows) + aux / world with respect to x
  and the parameters it holds, and the routing statistics of
  ``observe``; a run's ``t_local`` takes that many rows a rank, and a
  refused route reports its message as ``error``.

The spec's ``device`` ("cpu" by default; "cuda": every rank on the
current card) and ``backend`` ("gloo" by default) place the ranks.
Every rank writes ``rank{r}.pkl`` (the results by case name) into
``out_dir``.
"""

import os
import pickle
import sys
import time


def _tree_flat(engine, flat):
    """A whole flat buffer (the natural layout) → {JAX path key: fp32
    numpy leaf}."""
    from deeperspeed_tpu_torch.checkpoint.serialization import path_key
    arr = flat.detach().float().cpu().numpy()
    return {path_key(n): arr[lo:hi].reshape(shape).copy()
            for n, lo, hi, shape in engine.natural_slices}


def _mesh(case, world):
    """The case's ``mesh``: None, an axis name ("expert", "data": 1-D over
    the ranks) or "data,expert" (2-D, 1 × world)."""
    if not case.get("mesh"):
        return None
    from torch.distributed.device_mesh import init_device_mesh
    names = tuple(case["mesh"].split(","))
    shape = (1,) * (len(names) - 1) + (world,)
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _whole(engine, t):
    """A flat buffer of the state whole, in the natural order (gathered
    over the ranks where each holds a partition)."""
    return engine._natural_flat(t.detach())


def _state_bytes(engine):
    """This rank's training-state bytes by buffer."""
    def nb(t):
        return t.numel() * t.element_size()
    out = {"params": nb(engine._params_flat),
           "exp_avg": nb(engine.opt_state.exp_avg),
           "exp_avg_sq": nb(engine.opt_state.exp_avg_sq)}
    if engine._grads_flat is not None:
        out["grads"] = nb(engine._grads_flat)
    if engine._z3 is not None:
        out["persist"] = nb(engine._z3.persist)
    if engine._master.untyped_storage().data_ptr() != \
            engine._params_flat.untyped_storage().data_ptr():
        out["master"] = nb(engine._master)   # not a view of the params
    if engine._grad_acc is not engine._grads_flat:
        out["grad_acc"] = nb(engine._grad_acc)
    if engine._grad_part is not None and \
            engine._grad_part is not engine._grad_acc:
        out["grad_part"] = nb(engine._grad_part)
    return out


def run_train(case, rank, world, device="cpu"):
    import numpy as np
    import torch

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.checkpoint import checkpointing
    from deeperspeed_tpu_torch.models import gpt_neox as neox
    from deeperspeed_tpu_torch.utils import distributed as ds_dist

    written = []
    ds_dist.host_staged = 0       # this case's collectives through the host
    save_obj = checkpointing.save_obj

    def recording(obj, path, *a, **kw):
        written.append(os.path.basename(path))
        return save_obj(obj, path, *a, **kw)
    checkpointing.save_obj = recording
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**case["size"]), device=device)
    if case.get("weights") is None:
        model.init_params(case["seed"])
    eng, *_ = dst.initialize(model=model, config_params=case["conf"],
                             model_parameters=case.get("weights"),
                             mesh=_mesh(case, world))
    if case.get("wait_for"):
        deadline = time.monotonic() + 150
        while not os.path.exists(case["wait_for"]):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{case['wait_for']} never appeared")
            time.sleep(0.2)
    loaded = None
    if case.get("load"):
        try:
            eng.load_checkpoint(case["load"])
        except dst.DeepSpeedConfigError as e:
            if not case.get("load_error"):
                raise
            return {"load_error": str(e)}
        loaded = _tree_flat(eng, _whole(eng, eng._master))
    edit = case.get("edit")
    if edit:
        with eng.gathered_parameters(modifier_rank=0) as full:
            node = full
            for key in edit["leaf"].split("/")[:-1]:
                node = node[int(key)] if key.isdigit() else node[key]
            node[edit["leaf"].split("/")[-1]][0] = edit["value"]
    tokens = np.asarray(case["tokens"])
    micro = tokens.shape[1] // world
    mine = torch.from_numpy(np.ascontiguousarray(
        tokens[:, rank * micro:(rank + 1) * micro])).to(device)
    inject = case.get("inject_inf")
    if inject:
        reduced = eng._reduced_grads

        def poisoned():
            grads = reduced()
            if eng.global_steps + eng.skipped_steps + 1 == inject["step"] \
                    and rank == inject["rank"]:
                grads[grads.numel() // 2] = float("inf")
            return grads
        eng._reduced_grads = poisoned
    losses, masters, step_s = [], [], []
    save_at = case.get("save_at", case["steps"])
    hooked = None
    for step in range(case["steps"]):
        if step == 0 and case.get("hook"):
            eng.set_layers_to_hook(case["hook"])
        t0 = time.perf_counter()
        if case.get("legacy"):
            loss = None
            for i in range(mine.shape[0]):
                eng.backward(eng((mine[i], mine[i])))
                loss = eng.step()
            losses.append(loss)
        else:
            losses.append(eng.train_batch(batch=(mine, mine)))
        step_s.append(time.perf_counter() - t0)
        if step == 0 and case.get("hook"):
            hooked = {i: a.float().cpu().numpy() for i, a in
                      eng.get_hooked_activations().items()}
        if case.get("masters_each_step"):
            masters.append(_tree_flat(eng, _whole(eng, eng._master)))
        if case.get("save") and step + 1 == save_at:
            eng.save_checkpoint(case["save"])
    checkpointing.save_obj = save_obj
    out = {"losses": losses, "written": sorted(written),
           "step_ms": [t * 1e3 for t in step_s],
           "masters_each_step": masters,
           "loss_scale": eng.loss_scale,
           "skipped_steps": eng.skipped_steps,
           "global_steps": eng.global_steps,
           "state_bytes": _state_bytes(eng),
           "num_params": eng.num_params,
           "part": tuple(eng._part) if eng._part is not None else None,
           "dp_world_size": eng.dp_world_size, "ep": eng.ep,
           "host_staged": ds_dist.host_staged}
    if loaded is not None:
        out["loaded_master"] = loaded
    if case.get("master_file"):
        whole = _whole(eng, eng._master)      # a collective on every rank
        if rank == 0:
            torch.save(whole.float().cpu(), case["master_file"])
        del whole
    if not case.get("light"):
        out["master"] = _tree_flat(eng, _whole(eng, eng._master))
        out["params"] = _tree_flat(eng, _whole(eng, eng._params_flat))
    if case.get("eval"):
        out["eval"] = eng.eval_batch((mine[0], mine[0]))
    if hooked is not None:
        out["hooked"] = hooked
    if case.get("consolidated"):
        tree = eng._zero3_consolidated_fp16_state_dict()
        out["consolidated"] = {
            "/".join(map(str, path)): (str(t.dtype), t.float().numpy())
            for path, t in _paths(tree)}
    if eng._z3 is not None:
        out["collectives"] = {"gathers": eng._z3.gathers,
                              "reduce_scatters": eng._z3.reduce_scatters}
        out["layout"] = {"part_size": eng._z3.layout.part_size,
                         "persisted": eng._z3.layout.persisted_numel,
                         "persisted_padded":
                             eng._z3.layout.persisted_padded}
    del eng
    return out


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def run_csr(case, rank, world):
    import torch

    from deeperspeed_tpu_torch.runtime.csr_tensor import (CSRTensor,
                                                           csr_allreduce)
    dense = torch.as_tensor(case["dense"][rank])
    out = csr_allreduce(CSRTensor(dense))
    return {"indices": out.indices.numpy(), "values": out.values.numpy(),
            "dense": out.to_dense().numpy()}


def run_stage1(case, rank, world):
    import torch

    from deeperspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
    from deeperspeed_tpu_torch.runtime.zero.stage2 import (
        FP16_DeepSpeedZeroOptimizer, FP16_DeepSpeedZeroOptimizer_Stage2)
    from deeperspeed_tpu_torch.runtime.zero.stage1 import \
        FP16_DeepSpeedZeroOptimizer_Stage1
    params = [torch.as_tensor(p) for p in case["params"]]
    grads = [torch.as_tensor(g[rank]) for g in case["grads"]]
    out = {}
    for cls in (FP16_DeepSpeedZeroOptimizer_Stage1,
                FP16_DeepSpeedZeroOptimizer_Stage2):
        opt = cls(FusedAdam(lr=0.1, eps=1e-3), precision=torch.float32,
                  dynamic_loss_scale=True,
                  dynamic_loss_args={"init_scale": 4.0}, clip_grad=1.0)
        state = opt.init_state(params)
        scaled = [g * 4.0 for g in grads]
        if cls.stage == 2:
            scaled = opt.reduce_gradients(scaled)
        state, info = opt.step(state, scaled)
        sd = opt.state_dict(state)
        fresh = opt.init_state(params)
        fresh = opt.load_state_dict(fresh, sd)
        out[cls.stage] = {
            "params": [p.clone().numpy() for p in opt.unflatten(
                state.params)],
            "overflow": info.overflow, "norm": float(info.grad_norm),
            "scale": state.scale.cur_scale,
            "sub_partitions": [[p.numpy() for p in parts] for parts in
                               sd["local_sub_partitions_of_fp32_groups"]],
            "reloaded_equal": bool(torch.equal(fresh.master, state.master)
                                   and torch.equal(fresh.params,
                                                   state.params))}
    out["alias"] = FP16_DeepSpeedZeroOptimizer is \
        FP16_DeepSpeedZeroOptimizer_Stage2
    return out


def run_loader(case, rank, world):
    from deeperspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
    loader = DeepSpeedDataLoader(list(range(case["n"])), batch_size=2,
                                 shuffle=True, seed=3)
    return {"num_replicas": loader.num_replicas, "rank": loader.rank,
            "order": [b.tolist() for b in loader]}


def run_refuse(case, rank, world):
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.models import gpt_neox as neox
    out = {}
    for name, conf in case["confs"].items():
        conf = dict(conf)
        if conf.pop("model", None) == "gpt2":
            model = dst.GPT2(dst.GPT2Config.tiny(), device="cpu")
        else:
            model = neox.GPTNeoX(neox.GPTNeoXConfig(**case["size"]),
                                 device="cpu")
        mesh = conf.pop("mesh", case.get("mesh"))
        try:
            dst.initialize(model=model, config_params=conf,
                           mesh=_mesh({"mesh": mesh}, world)
                           if isinstance(mesh, str) else mesh)
            out[name] = None
        except (dst.DeepSpeedConfigError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def run_moe_fn(case, rank, world):
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.moe import layer as ml
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("expert",))
    x_all = torch.from_numpy(np.asarray(case["x"]))
    w_all = torch.from_numpy(np.asarray(case["w"]))
    out = []
    for kw in case["runs"]:
        kw = dict(kw)
        fn = kw.pop("fn")
        T = kw.pop("t_local", x_all.shape[0] // world)
        rows = slice(rank * T, (rank + 1) * T)
        params = {k: torch.from_numpy(np.asarray(v))
                  for k, v in case["params"].items()}
        if fn != "dense":
            params = ml.expert_shard(params, rank, world)
        params = {k: v.clone().requires_grad_() for k, v in params.items()}
        x = x_all[rows].clone().requires_grad_()
        ml.ROUTING_STATS.drain()
        if fn == "dense":
            try:
                y, aux = ml.moe_ffn_dense(params, x, group=dist.group.WORLD,
                                          **kw)
            except dst.DeepSpeedConfigError as e:
                out.append({"error": str(e)})
                continue
        elif fn == "ep":
            y, aux = ml.moe_ffn_expert_parallel(params, x, mesh, world, **kw)
        else:
            layer = ml.MoELayer(x.shape[1], params["w_in"].shape[-1],
                                params["gate"].shape[1], mesh=mesh,
                                device="cpu", **kw)
            y, aux = layer.apply(params, x)
        ((y * w_all[rows]).sum() + aux / world).backward()
        stats = ml.ROUTING_STATS.drain()
        out.append({
            "y": y.detach().numpy(), "aux": float(aux),
            "dx": x.grad.numpy(),
            "grads": {k: v.grad.numpy() for k, v in params.items()},
            "stats": None if stats is None else
            {k: float(v) for k, v in stats.items()}})
    return out


def run_zero_api(case, rank, world):
    """`zero.Init` / `GatheredParameters` over the group, on the leaves
    of ``case["tree"]`` (numpy)."""
    import numpy as np
    import torch

    from deeperspeed_tpu_torch.runtime import zero
    tree = case["tree"]

    def init_fn():
        return {k: torch.as_tensor(v) for k, v in tree.items()}
    out = {}
    with zero.Init(stage=3, param_persistence_threshold=16) as ctx:
        out["current"] = zero.current_init_context() is ctx
        params = ctx.materialize(init_fn)
    out["after"] = zero.current_init_context() is None
    out["local"] = {k: (tuple(p.local.shape), p.persisted)
                    for k, p in params.items()}
    with zero.Init(stage=3, enabled=False) as ctx:
        off = ctx.materialize(init_fn)
    out["disabled_local"] = {k: tuple(p.local.shape) for k, p in off.items()}
    with zero.GatheredParameters(params) as full:
        out["gathered"] = {k: np.array(v) for k, v in full.items()}
        full["w"][:] = 5.0
    out["read_only_kept"] = bool(np.array_equal(
        params["w"].full().numpy(), tree["w"]))
    gp = zero.GatheredParameters(params, modifier_rank=0)
    with gp as full:
        full["w"][0, :] = 7.0 + rank      # rank 0's values win
    out["updated_local"] = tuple(gp.updated["w"].local.shape)
    out["updated"] = gp.updated["w"].full().numpy()
    with zero.GatheredParameters(params, enabled=False) as same:
        out["passthrough"] = same is params
    module, param = object(), object()
    zero.register_external_parameter(module, param)
    zero.unregister_external_parameter(module, param)
    return out


RUNNERS = {"train": run_train, "csr": run_csr, "stage1": run_stage1,
           "loader": run_loader, "refuse": run_refuse,
           "zero_api": run_zero_api, "moe_fn": run_moe_fn}


def main():
    spec_path, out_dir = sys.argv[1], sys.argv[2]
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist

    import deeperspeed_tpu_torch as dst
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    device = spec.get("device", "cpu")
    dst.init_distributed(dist_backend=spec.get("backend", "gloo"),
                         timeout=spec.get("timeout", 120), verbose=False)
    results = {}
    for case in spec["cases"]:
        kw = {"device": device} if case["kind"] == "train" else {}
        results[case["name"]] = RUNNERS[case["kind"]](case, rank, world,
                                                      **kw)
        dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
