"""Training entry point (mirrors tise_tpu/models/main.py; reference:
AttnGAN++/main.py and miscc/utils.py ``get_parameters``).

The caption-image dataset, the frozen DAMSM encoders and the trainer behind
one CLI with the JAX CLI's flags, plus ``--device`` (the card by default; it
raises where there is none unless ``--device cpu`` is given); ``--gpu_id``
is accepted and ignored.

    python -m tise_tpu_torch.models.main --data_dir data/coco --dataset coco \\
        --net_e DAMSMencoders/coco/text_encoder100.pth \\
        --image_encoder DAMSMencoders/coco/image_encoder100.pth \\
        --output_dir output/coco_attngan_pp --gf_dim 64 --df_dim 32 --num_residual 3 --words_num 20

``--model counter_model`` trains the CounterModel (its generator, the MSG
discriminator, lambda 5) through the same loop; its step uploads and
normalizes only the batch's 256 px image.  ``--net_e`` and
``--image_encoder`` take the reference's ``.pth`` or the JAX package's
``.npz`` (DAMSM pretraining's ``best_*_encoder.npz``).  Snapshots go to ``<output_dir>/checkpoints``: the
trainer state (``epoch_<n>.pt``, resumed from on the next run) and the EMA
generator (``epoch_<n>.npz``, the generate CLIs' ``--checkpoint``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tise_tpu_torch.core.config import add_device_flag, configure_precision, resolve_device


def get_parameters() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--train", type=lambda s: s.lower() in ("1", "true", "yes"), default=True)
    p.add_argument("--model", choices=["attngan_pp", "counter_model"], default="attngan_pp")
    p.add_argument("--dataset", type=str, default="birds")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="output/run")
    p.add_argument("--version", type=str, default="")
    p.add_argument("--gpu_id", type=int, default=0, help="ignored (--device picks the device)")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--manual_seed", type=int, default=100)
    # model dims (miscc/config.py defaults)
    p.add_argument("--gf_dim", type=int, default=128)
    p.add_argument("--df_dim", type=int, default=64)
    p.add_argument("--z_dim", type=int, default=100)
    p.add_argument("--condition_dim", type=int, default=100)
    p.add_argument("--text_emb_dim", type=int, default=256)
    p.add_argument("--num_residual", type=int, default=2)
    p.add_argument("--num_branch", type=int, default=3)
    p.add_argument("--base_size", type=int, default=64)
    p.add_argument("--words_num", type=int, default=18)
    p.add_argument("--caps_per_img", type=int, default=10)
    # training
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_epoch", type=int, default=600)
    p.add_argument("--snapshot_interval", type=int, default=5)
    p.add_argument("--d_lr", type=float, default=2e-4)
    p.add_argument("--g_lr", type=float, default=2e-4)
    p.add_argument("--encoder_precision", choices=("highest", "fast"), default="highest",
                   help="the frozen DAMSM image encoder in the G loss: 'fast' = its forward and backward in bf16, "
                        "the loss in f32")
    p.add_argument("--smooth_gamma_1", type=float, default=5.0)
    p.add_argument("--smooth_gamma_2", type=float, default=5.0)
    p.add_argument("--smooth_gamma_3", type=float, default=10.0)
    p.add_argument("--smooth_lambda", type=float, default=1.0,
                   help="the DAMSM weight of AttnGAN++; --model counter_model ignores it and takes 5.0")
    # frozen encoders
    p.add_argument("--net_e", type=str, required=True, help="DAMSM text encoder (.pth/.npz)")
    p.add_argument("--image_encoder", type=str, required=True, help="DAMSM image encoder (.pth/.npz)")
    add_device_flag(p)
    return p


def main(argv=None) -> list:
    """-> the training loop's records, one an epoch this run trained."""
    args = get_parameters().parse_args(argv)
    if not args.train:
        raise SystemExit("evaluation-image generation lives in tise_tpu_torch.models.generate")
    device = resolve_device(args.device)

    from tise_tpu_torch.backbones import damsm
    from tise_tpu_torch.models import datasets as ds
    from tise_tpu_torch.models.attngan_pp import losses
    from tise_tpu_torch.models.attngan_pp.generator import GanConfig
    from tise_tpu_torch.models.attngan_pp.train_loop import train
    from tise_tpu_torch.models.attngan_pp.trainer import TrainConfig

    configure_precision("highest")  # TF32 off: the f32 step is the reference's
    np.random.seed(args.manual_seed)
    torch.manual_seed(args.manual_seed)
    dataset = ds.TextImageDataset(
        args.data_dir, "train", base_size=args.base_size, branch_num=args.num_branch, words_num=args.words_num,
        captions_per_image=args.caps_per_img, seed=args.manual_seed,
        augment=True)  # Scale(76/64) + RandomCrop + Flip (AttnGAN++/main.py image_transform)
    gan = GanConfig(gf_dim=args.gf_dim, df_dim=args.df_dim, z_dim=args.z_dim, condition_dim=args.condition_dim,
                    embedding_dim=args.text_emb_dim, r_num=args.num_residual, branch_num=args.num_branch,
                    words_num=args.words_num)
    module = None
    lam = args.smooth_lambda
    if args.model == "counter_model":
        from tise_tpu_torch.models.counter_model import trainer as module

        lam = module.default_config().damsm.lam
    weights = losses.DamsmWeights(gamma1=args.smooth_gamma_1, gamma2=args.smooth_gamma_2,
                                  gamma3=args.smooth_gamma_3, lam=lam)
    cfg = TrainConfig(gan=gan, batch_size=args.batch_size, g_lr=args.g_lr, d_lr=args.d_lr,
                      max_epoch=args.max_epoch, snapshot_interval=args.snapshot_interval, ntoken=dataset.n_words,
                      damsm=weights, encoder_precision=args.encoder_precision)
    _, records = train(cfg, dataset, args.output_dir, text_state=damsm.load_rnn_state_dict(args.net_e),
                       image_state=damsm.load_cnn_state_dict(args.image_encoder), device=device,
                       num_workers=args.num_workers, module=module)
    for r in records:
        print(f"epoch {r['epoch']}: {r['steps']} steps in {r['seconds']:.2f} s, {r['data_wait_s']:.2f} s waiting "
              f"for data; " + ", ".join(f"{k} {v:.4f}" for k, v in r["metrics"].items()))
    return records


if __name__ == "__main__":
    main()
