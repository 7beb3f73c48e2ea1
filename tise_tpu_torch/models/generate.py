"""Evaluation-image generation in PyTorch (mirrors tise_tpu/models/generate.py;
reference: AttnGAN++/coco_gen_image_from_caption.py,
coco_gen_soa_input_images.py, coco_gen_PA_input_images.py,
cub_gen_image_from_caption.py).

Three layouts, selected by --mode:
  flat  caption pickle (list of {caption_id, caption}) ->
        ``<out>/<caption_id>.png``            (coco_gen_image_from_caption.py:198-203)
  soa   {label_dir: [items]} -> ``<out>/<label_dir>/<caption_id>_<k>.png``
        with --images_per_caption (3)         (coco_gen_soa_input_images.py:163-213)
  pa    {positional_word: [items]} -> ``<out>/<word>/<caption_id>.png``
        (coco_gen_PA_input_images.py:160-212)

    python -m tise_tpu_torch.models.generate --caption_file caps.pkl --output_dir gen/ \\
        --checkpoint g.npz --text_encoder text_encoder.pth --captions_pickle captions.pickle \\
        [--mode flat|soa|pa] [--model attngan_pp|counter_model] [--device cpu]

The generator checkpoint is the JAX package's ``.npz`` (``g_ema`` or
``g_params``, and ``g_batch_stats``); the DAMSM text encoder a reference
``.pth`` or a JAX ``.npz``.  The finest scale is written, as
``clip((x + 1) * 127.5, 0, 255)`` truncated to uint8.  Runs in f32 with TF32
off (the JAX CLIs have no --precision), on the card unless --device cpu.

Noise: the JAX CLIs draw z and CA's eps from ``split(fold_in(PRNGKey(seed),
step))``, which a ``torch.Generator`` cannot reproduce.  Every draw of the
port goes through :func:`draw_noise` with the JAX step numbering (the
batch's first index plus the group's offset), always for the full static
batch, so row i belongs to item i in a short last batch too; tests put
JAX's draws in its place to compare the CLIs image for image.  PNGs are
written by a pool of threads while the card runs the next batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from tise_tpu_torch.backbones import damsm
from tise_tpu_torch.core import io as result_io
from tise_tpu_torch.core.config import add_device_flag, configure_precision, resolve_device
from tise_tpu_torch.core.weights import load_pytree_npz
from tise_tpu_torch.metrics.rp_cub import load_vocab, tokenize_caption
from tise_tpu_torch.models import weights as g_weights
from tise_tpu_torch.models.attngan_pp.generator import GanConfig

PNG_WORKERS = 8
PNG_BATCHES_IN_FLIGHT = 2  # batches whose PNGs may still be writing while the next one runs


def draw_noise(seed: int, step: int, batch: int, z_dim: int, condition_dim: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """z [batch, z_dim] and CA's eps [batch, condition_dim] of ``step`` in a
    run seeded ``seed``: one ``torch.Generator`` on ``device`` seeded from
    (seed, step) through numpy's SeedSequence."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]))
    z = torch.randn((batch, z_dim), generator=gen, device=device)
    return z, torch.randn((batch, condition_dim), generator=gen, device=device)


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW -> uint8 NHWC (coco_gen_image_from_caption.py:149-153)."""
    return ((images + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)


class CaptionGenerator:
    """Caption ids -> images on one device: the DAMSM text encoder, the
    noise of :func:`draw_noise` and the generator in eval mode."""

    def __init__(self, g_state, text_state, *, gan: GanConfig, model: str = "attngan_pp", seed: int = 100,
                 device=None):
        self.device = resolve_device(device)
        self.gan, self.seed = gan, seed
        self.gnet = g_weights.load_generator(g_state, gan, model, self.device)
        self.text_encoder = damsm.RNNEncoder.from_state_dict(text_state, device=self.device)

    @torch.no_grad()
    def sample(self, captions: np.ndarray, cap_lens: np.ndarray, step: int):
        """-> the generator's (images NCHW by scale, attention maps, mu, logvar)."""
        caps = torch.from_numpy(np.ascontiguousarray(captions, np.int64)).to(self.device)
        words, sent = self.text_encoder(caps, cap_lens)
        z, eps = draw_noise(self.seed, step, caps.shape[0], self.gan.z_dim, self.gan.condition_dim, self.device)
        return self.gnet(z, sent, words, caps == 0, eps)

    def __call__(self, captions: np.ndarray, cap_lens: np.ndarray, step: int) -> np.ndarray:
        """-> the finest scale, uint8 [B, H, W, 3] on the host."""
        return to_uint8(self.sample(captions, cap_lens, step)[0][-1]).cpu().numpy()


def _tokenize_items(items: Sequence[Dict], wordtoix: Dict[str, int], words_num: int):
    caps = np.zeros((len(items), words_num), np.int32)
    lens = np.ones((len(items),), np.int32)
    for i, item in enumerate(items):
        ids = tokenize_caption(item["caption"], wordtoix)[:words_num]
        if ids:
            caps[i, : len(ids)] = ids
            lens[i] = len(ids)
    return caps, lens


def _save_png(image: np.ndarray, path: str) -> None:
    Image.fromarray(image).save(path)


def generate_flat(
    items: Sequence[Dict],
    out_dir: str,
    gen: CaptionGenerator,
    wordtoix: Dict[str, int],
    *,
    batch_size: int = 32,
    words_num: int = 18,
    name_fn=None,
    step_offset: int = 0,
) -> int:
    os.makedirs(out_dir, exist_ok=True)
    name_fn = name_fn or (lambda item, k: f"{item['caption_id']}.png")
    written = 0
    pending: deque = deque()
    with ThreadPoolExecutor(PNG_WORKERS) as pool:
        for start in range(0, len(items), batch_size):
            chunk = list(items[start: start + batch_size])
            caps, lens = _tokenize_items(chunk, wordtoix, words_num)
            pad = batch_size - len(chunk)
            if pad:
                caps = np.concatenate([caps, np.zeros((pad, words_num), np.int32)])
                lens = np.concatenate([lens, np.ones((pad,), np.int32)])
            imgs = gen(caps, lens, step_offset + start)
            pending.append([pool.submit(_save_png, imgs[i], os.path.join(out_dir, name_fn(item, 0)))
                            for i, item in enumerate(chunk)])
            written += len(chunk)
            while len(pending) > PNG_BATCHES_IN_FLIGHT:
                for f in pending.popleft():
                    f.result()
        for batch in pending:
            for f in batch:
                f.result()
    return written


def generate_grouped(
    data: Dict[str, Sequence[Dict]],
    out_dir: str,
    gen: CaptionGenerator,
    wordtoix: Dict[str, int],
    *,
    batch_size: int = 32,
    words_num: int = 18,
    images_per_caption: int = 1,
    indexed_names: bool = False,
) -> int:
    """soa/pa layouts: one subfolder per group key."""
    written = 0
    for g_idx, (group, items) in enumerate(sorted(data.items())):
        gdir = os.path.join(out_dir, group)
        for k in range(images_per_caption):
            name_fn = (
                (lambda item, _k, k=k: f"{item['caption_id']}_{k}.png")
                if indexed_names
                else (lambda item, _k: f"{item['caption_id']}.png")
            )
            written += generate_flat(
                items, gdir, gen, wordtoix,
                batch_size=batch_size, words_num=words_num, name_fn=name_fn,
                step_offset=(g_idx * images_per_caption + k) * 1_000_000,
            )
    return written


def load_generator_from_checkpoint(ckpt_path: str, text_encoder_path: str, gan: GanConfig, ntoken: int,
                                   model: str):
    """-> (the generator's state dict, the text encoder's): the EMA params
    (``g_ema``, else ``g_params``) and ``g_batch_stats`` of the JAX
    package's ``.npz``; the DAMSM text encoder from a ``.pth`` or ``.npz``,
    whose vocabulary must be ``ntoken`` rows and whose LSTM must be
    ``embedding_dim // 2`` wide."""
    if not ckpt_path.endswith(".npz"):
        raise ValueError(
            f"{ckpt_path}: generator checkpoints are read as the JAX package's .npz "
            "(g_ema or g_params, g_batch_stats); an Orbax checkpoint directory is a JAX format, "
            "write it out as .npz first (tise_tpu.core.weights.save_pytree_npz)")
    tree = load_pytree_npz(ckpt_path)
    g_params = tree.get("g_ema", tree.get("g_params"))
    if g_params is None:
        raise KeyError(f"{ckpt_path} holds neither g_ema nor g_params")
    g_state = g_weights.g_state_dict_from_jax_params(g_params, tree.get("g_batch_stats", {}), model)
    text_state = damsm.load_rnn_state_dict(text_encoder_path)
    rows, hidden = np.shape(text_state["encoder.weight"])[0], np.shape(text_state["rnn.weight_hh_l0"])[1]
    if rows != ntoken or hidden != gan.embedding_dim // 2:
        raise ValueError(f"{text_encoder_path}: the text encoder has {rows} words and {hidden} LSTM units; "
                         f"the vocabulary has {ntoken} words and --embedding_dim {gan.embedding_dim} "
                         f"needs {gan.embedding_dim // 2} units")
    return g_state, text_state


def add_generator_flags(p: argparse.ArgumentParser) -> None:
    """The flags the two CLIs share, as the JAX CLIs spell them."""
    p.add_argument("--checkpoint", type=str, required=True, help="generator checkpoint (the JAX package's .npz)")
    p.add_argument("--text_encoder", type=str, required=True)
    p.add_argument("--captions_pickle", type=str, required=True, help="vocab source")
    p.add_argument("--words_num", type=int, default=18)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--gf_dim", type=int, default=128)
    p.add_argument("--z_dim", type=int, default=100)
    p.add_argument("--condition_dim", type=int, default=100)
    p.add_argument("--embedding_dim", type=int, default=256)
    add_device_flag(p)


def gan_config(args) -> GanConfig:
    """The JAX CLIs' GanConfig (no --r_num: ``checkpoint_gan`` reads it from
    the checkpoint)."""
    return GanConfig(gf_dim=args.gf_dim, z_dim=args.z_dim, condition_dim=args.condition_dim,
                     embedding_dim=args.embedding_dim, words_num=args.words_num)


def checkpoint_gan(gan: GanConfig, g_state: Mapping[str, Any]) -> GanConfig:
    """``gan`` with the R_NUM that the checkpoint's stages hold.  The JAX CLIs
    always run 2 and drop any further block (ROADMAP Queue 3 item 11); a
    snapshot of ``models.main --num_residual 3`` holds 3."""
    return dataclasses.replace(gan, r_num=g_weights.r_num_of(g_state, gan.r_num))


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--caption_file", type=str, required=True, help="caption pickle (schema per mode)")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--mode", choices=["flat", "soa", "pa"], default="flat")
    p.add_argument("--model", choices=["attngan_pp", "counter_model"], default="attngan_pp")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--images_per_caption", type=int, default=3, help="(soa mode)")
    add_generator_flags(p)
    args = p.parse_args(argv)

    configure_precision("highest")
    ixtoword, wordtoix = load_vocab(args.captions_pickle)
    gan = gan_config(args)
    g_state, text_state = load_generator_from_checkpoint(args.checkpoint, args.text_encoder, gan, len(ixtoword),
                                                         args.model)
    gan = checkpoint_gan(gan, g_state)
    gen = CaptionGenerator(g_state, text_state, gan=gan, model=args.model, seed=args.seed, device=args.device)
    data = result_io.load_pickle(args.caption_file)
    kw = {"batch_size": args.batch_size, "words_num": args.words_num}
    if args.mode == "flat":
        n = generate_flat(data, args.output_dir, gen, wordtoix, **kw)
    elif args.mode == "soa":
        n = generate_grouped(data, args.output_dir, gen, wordtoix, images_per_caption=args.images_per_caption,
                             indexed_names=True, **kw)
    else:
        n = generate_grouped(data, args.output_dir, gen, wordtoix, **kw)
    print(f"wrote {n} images to {args.output_dir}")


if __name__ == "__main__":
    main()
