"""The rank function of `tests/test_torch_longseq.py`'s gloo world, in a
module without JAX so that each rank starts in a few seconds: on a (1, 2)
mesh, the manual TP+SP block (internlm2 SMOKE) and the automatic TP path
(qwen2 SMOKE, whose QKV bias the manual block refuses) each run
`loss_fn` and its backward with remat and without; every rank returns
the losses, its gradients and the collectives it recorded."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import init_params, loss_fn

TP_CASES = [("manual", "internlm2_20b"), ("automatic", "qwen2_1p5b")]


def batch(cfg, seed, b=2, l=32):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randint(0, cfg.vocab, (b, l)))
            for k in ("tokens", "labels")}


def rank_main(rank, world, init):
    import torch.distributed as dist
    from repro_torch.dist import set_mesh, shard_params
    from repro_torch.dist.collectives import record_collectives
    from repro_torch.launch.mesh import init_world, make_mesh
    init_world(init_method=init, rank=rank, world_size=world, device="cpu")
    mesh = make_mesh((1, 2))
    res = {}
    for case, arch in TP_CASES:
        base = get_smoke(arch)
        data = batch(base, 11)
        for remat in (False, True):
            model = init_params(dataclasses.replace(base, remat=remat),
                                device="cpu")
            shard_params(model, mesh)
            model.trainable_()
            with set_mesh(mesh), record_collectives() as rec:
                loss, _ = loss_fn(model, data)
                loss.backward()
            res[(case, remat)] = {
                "loss": loss.item(),
                "grads": {n: p.grad.clone()
                          for n, p in model.named_parameters()},
                "calls": [(r["kind"], str(r["site"]), r["phase"])
                          for r in rec]}
    dist.barrier()
    dist.destroy_process_group()
    return res
