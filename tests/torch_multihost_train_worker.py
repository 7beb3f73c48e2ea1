"""Worker of tests/test_torch_multihost_train.py: one rank of a CPU gloo
cluster that runs the port's sharded AttnGAN++ step.

    python tests/torch_multihost_train_worker.py RANK WORLD PORT DIR

``DIR/world.pkl`` holds the config's widths, the seeded state dicts, the
global batch (uint8 images) and the global z and eps.  The rank takes its
shard of the batch and its rows of the noise, runs one step from the same
state in f32 and in float64, then once more in f32 for each of three local
forms that a sharded step must not take (BatchNorm moments of the local
batch, the DAMSM losses of the local batch, gradients not averaged), and
writes ``DIR/rank<RANK>_<run>.pkl`` with what the step returned and left:
the metrics, G's and each D's gradients, G's running statistics, each D's
u, the EMA and the parameters.
"""

import os
import pickle
import sys
from unittest import mock

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tise_tpu_torch import parallel  # noqa: E402
from tise_tpu_torch.models.attngan_pp import layers, losses, trainer  # noqa: E402
from tise_tpu_torch.models.attngan_pp.generator import GanConfig  # noqa: E402


def local_batch_norm(x, dims, group):
    """The local form of ``layers.global_moments``."""
    return torch.var_mean(x, dim=dims, correction=0)


def local_damsm(region, cnn_code, words_embs, sent_emb, cap_lens, class_ids, w, group):
    """The local form of the DAMSM terms: this rank's batch alone."""
    rows = losses.own_rows(region.shape[0], group)
    return GLOBAL_DAMSM(region, cnn_code, words_embs[rows], sent_emb[rows], cap_lens[rows], class_ids[rows], w)


GLOBAL_DAMSM = losses.generator_damsm_loss
LOCAL_FORMS = {
    "local_bn": (layers, "global_moments", local_batch_norm),
    "local_damsm": (losses, "generator_damsm_loss", local_damsm),
    "local_grad": (trainer, "average_gradients", lambda module, group: None),
}


def step_results(world: dict, group, dtype: torch.dtype) -> dict:
    """One sharded step from the world's state in ``dtype``: numpy leaves."""
    cfg = trainer.TrainConfig(gan=GanConfig(**world["gan"]), batch_size=world["batch_size"], ntoken=world["ntoken"])
    models = trainer.build_models(cfg, world["text"], world["image"], "cpu")
    models = trainer.Models(models.gnet.to(dtype), {s: d.to(dtype) for s, d in models.dnets.items()},
                            models.text_encoder.to(dtype), models.image_encoder.to(dtype))
    state = trainer.init_state(cfg, models, dicts=world["dicts"])
    rows = trainer.local_rows(cfg.batch_size, group)
    z, eps = (torch.tensor(world[k][rows], dtype=dtype) for k in ("z", "eps"))
    metrics = trainer.make_sharded_train_step(cfg, models, group)(
        state, trainer.shard_batch(world["batch"], group), z, eps)

    def leaves(module, what):
        return {k: v.detach().double().numpy() for k, v in what(module)}

    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "g_grad": {k: p.grad.double().numpy() for k, p in state.gnet.named_parameters()},
           "g_params": leaves(state.gnet, lambda m: m.named_parameters()),
           "g_stats": {k: v.double().numpy() for k, v in state.gnet.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))},
           "ema": {k: v.double().numpy() for k, v in state.g_ema.items()}}
    for s, d in state.dnets.items():
        out[f"d{s}_grad"] = {k: p.grad.double().numpy() for k, p in d.named_parameters()}
        out[f"d{s}_params"] = leaves(d, lambda m: m.named_parameters())
        out[f"d{s}_u"] = {k: v.double().numpy() for k, v in d.state_dict().items() if k.endswith(".u")}
    return out


def main() -> None:
    rank, world_size, port, folder = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    with open(os.path.join(folder, "world.pkl"), "rb") as f:
        world = pickle.load(f)
    device = parallel.init_distributed(f"127.0.0.1:{port}", world_size, rank, "cpu")
    group = parallel.step_group(device)
    runs = {"f32": (torch.float32, None), "f64": (torch.float64, None)}
    runs.update({name: (torch.float32, form) for name, form in LOCAL_FORMS.items()})
    for name, (dtype, form) in runs.items():
        with mock.patch.object(*form) if form else mock.patch.dict({}):
            out = step_results(world, group, dtype)
        with open(os.path.join(folder, f"rank{rank}_{name}.pkl"), "wb") as f:
            pickle.dump(out, f)
        print(f"[rank {rank}] {name}: {out['metrics']}", flush=True)
    parallel.multihost.barrier("train_done")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
