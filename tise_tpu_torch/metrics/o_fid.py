"""O-FID — FID over detector crops with the 80-class fine-tuned backbone
(mirrors tise_tpu/metrics/o_fid.py).

The reference's O-FID scripts are the FID slice with another backbone
checkpoint (object_fidelity/O-FID/inception.py:58-64 loads the 80-class
fine-tune) and another result label (O-FID/fid_score.py:220-222).  Here it is
the same engine as metrics/fid.py with the fine-tuned weights.
"""

from __future__ import annotations

import argparse

from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.metrics import fid as fid_metric


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    fid_metric.add_fid_flags(p, "80-class fine-tuned inception (.pth/.npz)")
    fid_metric.run_cli(
        fid_metric.parse_fid_args(p, argv), "O-FID", result_io.write_o_fid_result,
        "O-FID needs the 80-class fine-tuned inception weights",
    )


if __name__ == "__main__":
    main()
