"""Free-text example generation in PyTorch (mirrors
tise_tpu/models/gen_example.py; reference: AttnGAN++/main.py:28-75
``gen_example`` + trainer.py:643-706 ``Trainer.gen_example``).

Reads ``<data_dir>/example_filenames.txt`` (one caption-file name per line),
tokenizes each non-empty sentence of every ``<data_dir>/<name>.txt`` (the
\\w+ regex, lowercase, ascii filter; main.py:40-56), sorts a file's captions
by descending length (main.py:59-67), and for each file key writes

    <output_dir>/<key>/0_s_<original_caption_index>_g<k>.png

for every generator scale k (``(im + 1) * 127.5`` to uint8), and, unless
--no_attn, the attention super-image ``0_s_<idx>_attn.png`` of the finest
stage's maps (models/visualize.build_super_image).  <output_dir> defaults
to ``<checkpoint>_examples``.

    python -m tise_tpu_torch.models.gen_example --data_dir examples/ --checkpoint g.npz \\
        --text_encoder text_encoder.pth --captions_pickle captions.pickle [--device cpu]

The noise of file k (in sorted order) is ``generate.draw_noise(seed, k, ...)``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image

from tise_tpu_torch.core.config import configure_precision
from tise_tpu_torch.metrics.rp_cub import load_vocab, tokenize_caption
from tise_tpu_torch.models import generate, visualize


def read_example_captions(
    data_dir: str, wordtoix: Dict[str, int]
) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """-> {key: (captions [N, max_len] int32 desc-length-sorted, cap_lens,
    sorted_indices)} — main.py:28-73 semantics (key = basename of the listed
    caption file)."""
    listing = os.path.join(data_dir, "example_filenames.txt")
    with open(listing) as f:
        names = [n for n in f.read().split("\n") if n]
    data: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    for name in names:
        with open(os.path.join(data_dir, f"{name}.txt")) as f:
            sentences = [s for s in f.read().split("\n") if s]
        tokenized: List[List[int]] = []
        for sent in sentences:
            ids = tokenize_caption(sent, wordtoix)
            if ids:
                tokenized.append(ids)
        if not tokenized:
            continue
        cap_lens = np.asarray([len(t) for t in tokenized])
        sorted_indices = np.argsort(cap_lens)[::-1]
        cap_lens = cap_lens[sorted_indices]
        max_len = int(cap_lens[0])
        cap_array = np.zeros((len(tokenized), max_len), dtype=np.int32)
        for i, src in enumerate(sorted_indices):
            cap_array[i, : len(tokenized[src])] = tokenized[src]
        key = name[name.rfind("/") + 1:]
        data[key] = (cap_array, cap_lens.astype(np.int32), sorted_indices)
    return data


class ExampleSampler(generate.CaptionGenerator):
    """Caption batch -> (every scale as uint8 NHWC, the finest stage's word
    attention [B, T, ih, iw]) on the host; AttnGAN++ only, as in the JAX CLI."""

    def __init__(self, g_state, text_state, *, gan, seed: int, device=None):
        super().__init__(g_state, text_state, gan=gan, model="attngan_pp", seed=seed, device=device)

    def __call__(self, captions: np.ndarray, cap_lens: np.ndarray, step: int):
        fakes, attn, _mu, _logvar = self.sample(captions, cap_lens, step)
        imgs = [generate.to_uint8(f).cpu().numpy() for f in fakes]
        return imgs, (attn[-1].permute(0, 3, 1, 2).cpu().numpy() if attn else None)


def generate_examples(
    data: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]],
    output_dir: str,
    sampler: ExampleSampler,
    *,
    words_num: int,
    ixtoword=None,
    save_attn: bool = True,
) -> int:
    written = 0
    for step, (key, (captions, cap_lens, sorted_indices)) in enumerate(sorted(data.items())):
        save_dir = os.path.join(output_dir, key)
        os.makedirs(save_dir, exist_ok=True)
        # padded to words_num, as the JAX CLI pads for its one executable
        caps = np.zeros((captions.shape[0], words_num), np.int32)
        caps[:, : min(words_num, captions.shape[1])] = captions[:, :words_num]
        lens = np.minimum(cap_lens, words_num).astype(np.int32)
        imgs, attn = sampler(caps, lens, step)
        for j in range(captions.shape[0]):
            orig = int(sorted_indices[j])
            for k, scale_imgs in enumerate(imgs):
                Image.fromarray(scale_imgs[j]).save(os.path.join(save_dir, f"0_s_{orig}_g{k}.png"))
                written += 1
            if save_attn and attn is not None and ixtoword is not None:
                grid = visualize.build_super_image(
                    imgs[-1][j: j + 1].astype(np.float32) / 127.5 - 1.0,
                    attn[j: j + 1],
                    caps[j: j + 1],
                    lens[j: j + 1],
                    ixtoword,
                )
                grid.save(os.path.join(save_dir, f"0_s_{orig}_attn.png"))
    return written


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", type=str, required=True,
                   help="dir holding example_filenames.txt + the caption .txt files")
    p.add_argument("--output_dir", type=str, default=None,
                   help="default: <checkpoint>_examples (reference strips .pth)")
    p.add_argument("--no_attn", action="store_true", help="skip attention super-images")
    generate.add_generator_flags(p)
    args = p.parse_args(argv)

    configure_precision("highest")
    ixtoword, wordtoix = load_vocab(args.captions_pickle)
    gan = generate.gan_config(args)
    g_state, text_state = generate.load_generator_from_checkpoint(
        args.checkpoint, args.text_encoder, gan, len(ixtoword), "attngan_pp")
    gan = generate.checkpoint_gan(gan, g_state)
    sampler = ExampleSampler(g_state, text_state, gan=gan, seed=args.seed, device=args.device)
    out = args.output_dir or (os.path.splitext(args.checkpoint)[0] + "_examples")
    data = read_example_captions(args.data_dir, wordtoix)
    n = generate_examples(data, out, sampler, words_num=args.words_num, ixtoword=ixtoword,
                          save_attn=not args.no_attn)
    print(f"wrote {n} images to {out}")


if __name__ == "__main__":
    main()
