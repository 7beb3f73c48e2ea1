"""Worker of tests/test_torch_multihost.py: one rank of a CPU gloo cluster
that runs the port's multi-process metric paths.

    python tests/torch_multihost_worker.py RANK WORLD PORT DIR

It joins the cluster, then

  * runs the extractor and ``allgather_rows`` over ``DIR/plan.json``'s
    folder of 9 images with a cheap stand-in forward (an odd count with a
    padded tail; a float64 payload; one file over two ranks, an empty
    shard; legacy ``drop_last`` on the global list) and sums a seeded
    ``MomentState`` with ``psum_moments``; writes ``DIR/rank<RANK>.npz``;
  * runs each CLI of the plan through its ``main`` with
    ``--coordinator/--num-processes/--process-id`` added and ``{rank}`` in
    its argv replaced by the rank and ``{run}`` by ``dist``, the crop and SOA CLIs with the stub
    detector of tests/test_torch_soa.py, and RP-COCO recording the rows of
    every text bank it encodes; writes each CLI's printed lines to
    ``DIR/rank<RANK>/<cli>.log`` and the bank sizes to ``banks.json``.
"""

import contextlib
import importlib
import io
import json
import os
import sys
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tise_tpu_torch import parallel  # noqa: E402
from tise_tpu_torch.core.data import ImageFolderLoader, list_images  # noqa: E402
from tise_tpu_torch.metrics import crop_objects, soa  # noqa: E402
from tise_tpu_torch.metrics.clip_scorer import ClipPairScorer  # noqa: E402
from tise_tpu_torch.metrics.extractor import BatchedExtractor  # noqa: E402
from tise_tpu_torch.ops import stats  # noqa: E402
from tise_tpu_torch.parallel import multihost  # noqa: E402


def cheap_forward(x: torch.Tensor):
    """Per-image channel means and maxima of the normalized NHWC batch."""
    return {"feat": torch.cat([x.mean(dim=(1, 2)), x.amax(dim=(1, 2))], dim=-1)}


def seeded_moments(seed: int) -> stats.MomentState:
    acts = torch.from_numpy(np.random.RandomState(seed).standard_normal((5, 6)).astype(np.float32))
    return stats.update_moments(stats.init_moments(6, device="cpu"), acts)


def gather_cases(folder: str) -> dict:
    extractor = BatchedExtractor(cheap_forward, recipe="fid", device="cpu")
    files = list_images(folder)
    sel, gidx = multihost.shard_items(files)
    summed = stats.psum_moments(seeded_moments(multihost.process_index()))
    return {
        "feat": extractor.run(ImageFolderLoader(files, 4, 16))["feat"],
        "lens": multihost.allgather_rows(np.asarray([float(len(p)) for p in sel]), gidx, len(files)),
        "pi": multihost.allgather_rows(gidx.astype(np.float64) + np.pi, gidx, len(files)),
        "ids": multihost.allgather_rows(gidx * (2 ** 40) + 7, gidx, len(files)),
        "feat_one": extractor.run(ImageFolderLoader(files[:1], 4, 16))["feat"],
        "feat_drop": extractor.run(ImageFolderLoader(files, 4, 16, drop_last=True))["feat"],
        **{f"psum_{k}": v.numpy() for k, v in summed._asdict().items()},
    }


def main() -> None:
    rank, world, port, folder = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    with open(os.path.join(folder, "plan.json")) as f:
        plan = json.load(f)
    coordinator = f"127.0.0.1:{port}"
    parallel.init_distributed(coordinator, world, rank, "cpu")
    np.savez(os.path.join(folder, f"rank{rank}.npz"), **gather_cases(plan["images9"]))

    from tests.test_torch_soa import StubDetector

    out_dir = os.path.join(folder, f"rank{rank}")
    os.makedirs(out_dir, exist_ok=True)
    banks, encode = [], ClipPairScorer.encode_text_bank

    def recording_bank(self, tokens, **kw):
        banks.append(len(tokens))
        return encode(self, tokens, **kw)

    dist_flags = ["--coordinator", coordinator, "--num-processes", str(world), "--process-id", str(rank)]
    with mock.patch.object(crop_objects, "build_detector", lambda args: StubDetector()), \
            mock.patch.object(soa, "build_detector", lambda args: StubDetector()), \
            mock.patch.object(ClipPairScorer, "encode_text_bank", recording_bank):
        for name, module, argv in plan["clis"]:
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                importlib.import_module(module).main([a.replace("{rank}", str(rank)).replace("{run}", "dist") for a in argv]
                                                      + dist_flags)
            with open(os.path.join(out_dir, f"{name}.log"), "w") as f:
                f.write(text.getvalue())
    with open(os.path.join(out_dir, "banks.json"), "w") as f:
        json.dump(banks, f)
    multihost.barrier("done")
    torch.distributed.destroy_process_group()
    print(f"[rank {rank}] OK", flush=True)


if __name__ == "__main__":
    main()
