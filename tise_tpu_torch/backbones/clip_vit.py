"""CLIP ViT-B/32 (image and text towers) in PyTorch (mirrors
tise_tpu/backbones/clip_vit.py).

The backbone of RP-COCO (text_relevance/RP_coco.py:31,73: rank the ground-truth
caption against 99 mismatched ones by image-text logits) and PA
(positional_alignment/PA.py:30-43: caption against false caption, success iff
P(gt) > 0.6).  Architecture of openai/CLIP "ViT-B/32":

  image tower: 32x32 conv patchify (no bias) -> +class token -> +pos embed ->
    ln_pre -> 12 pre-LN transformer blocks (d=768, 12 heads, QuickGELU MLP) ->
    ln_post on the class token -> linear proj to 512
  text tower: 49408-token embedding, 77 positions, 12 pre-LN blocks (d=512,
    8 heads, causal mask) -> ln_final -> the EOT position -> text_projection
  similarity: logit_scale.exp() * normalize(img) @ normalize(txt).T

The parameter names are OpenAI's, so an OpenAI ``state_dict`` loads as is;
:func:`state_dict_from_jax_params` carries the JAX package's weights across.
The attention is written out as the JAX module computes it (q scaled before
the product, the causal -inf mask added in f32, the softmax in f32), not
through ``nn.MultiheadAttention`` or ``scaled_dot_product_attention``, whose
fused paths add in another order.  Images enter NHWC, normalized, as in the
JAX package; the module is f32 throughout (backbones/clip_fast.py is the
bf16 image tower).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tise_tpu_torch.core.config import resolve_device

LN_EPS = 1e-5

EMBED_DIM = 512

#: keys of an OpenAI checkpoint that hold no weight (build_model drops them too)
_META_KEYS = ("input_resolution", "context_length", "vocab_size")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MultiHeadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed ``in_proj`` and
    ``out_proj``), the JAX module's arithmetic."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        h = self.heads
        hd = d // h
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (a.reshape(b, t, h, hd).transpose(1, 2) for a in (q, k, v))
        attn = (q * (1.0 / np.sqrt(hd))) @ k.transpose(-1, -2)
        if mask is not None:
            attn = attn + mask
        out = torch.softmax(attn, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))


class Mlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = MultiHeadAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = Mlp(width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualBlock(width, heads) for _ in range(layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, mask)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, patch_size: int = 32, width: int = 768, layers: int = 12, heads: int = 12,
                 output_dim: int = EMBED_DIM, input_resolution: int = 224):
        super().__init__()
        grid = input_resolution // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=LN_EPS)
        self.transformer = Transformer(width, layers, heads)
        self.ln_post = nn.LayerNorm(width, eps=LN_EPS)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: normalized image NHWC [B, 224, 224, 3] -> [B, output_dim]."""
        x = self.conv1(x.permute(0, 3, 1, 2))  # [B, D, g, g]
        x = x.flatten(2).transpose(1, 2)  # [B, g*g, D], patches in row-major order
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj


class TextTransformer(nn.Module):
    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512, layers: int = 12,
                 heads: int = 8, output_dim: int = EMBED_DIM):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = Transformer(width, layers, heads)
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)
        self.text_projection = nn.Parameter(torch.empty(width, output_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: integer [B, 77] -> [B, output_dim] (EOT-pooled, projected)."""
        x = self.token_embedding(tokens) + self.positional_embedding
        t = tokens.shape[1]
        causal = torch.full((t, t), float("-inf"), device=x.device).triu(1)
        x = self.ln_final(self.transformer(x, causal))
        # EOT has the highest id of the CLIP vocabulary: argmax pooling
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return x @ self.text_projection


class CLIP(TextTransformer):
    """The joint ViT-B/32 model.  OpenAI's layout keeps the text tower's
    weights at the top level of the model, so CLIP is the text tower with the
    image tower (``visual``) and ``logit_scale`` added."""

    def __init__(self):
        super().__init__()
        self.visual = VisionTransformer()
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return super().forward(tokens)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits_per_image [B_img, B_txt], logits_per_text)."""
        img = self.encode_image(images)
        txt = self.encode_text(tokens)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        logits = self.logit_scale.exp() * img @ txt.T
        return logits, logits.T

    @classmethod
    def from_state_dict(cls, state_dict: Mapping[str, Any], device=None) -> "CLIP":
        """A ViT-B/32 model in f32 and eval mode on ``device`` (None: the
        card), holding a copy of ``state_dict``'s weights (OpenAI layout, no
        other key: ``load_params`` drops a checkpoint's non-weight entries)."""
        with torch.device("meta"):
            model = cls()
        sd = {k: torch.as_tensor(np.array(v, dtype=np.float32)) for k, v in state_dict.items()}
        model.load_state_dict(sd, strict=True, assign=True)
        return model.to(resolve_device(device)).eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _block_state(tree: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """One flax ResidualBlock -> OpenAI keys: Dense kernels [in, out] become
    Linear weights [out, in]; LayerNorm scale becomes weight."""
    out = {}
    for ln in ("ln_1", "ln_2"):
        out[f"{prefix}.{ln}.weight"] = tree[ln]["scale"]
        out[f"{prefix}.{ln}.bias"] = tree[ln]["bias"]
    out[f"{prefix}.attn.in_proj_weight"] = tree["attn"]["in_proj"]["kernel"].T
    out[f"{prefix}.attn.in_proj_bias"] = tree["attn"]["in_proj"]["bias"]
    out[f"{prefix}.attn.out_proj.weight"] = tree["attn"]["out_proj"]["kernel"].T
    out[f"{prefix}.attn.out_proj.bias"] = tree["attn"]["out_proj"]["bias"]
    for name in ("c_fc", "c_proj"):
        out[f"{prefix}.mlp.{name}.weight"] = tree[f"mlp_{name}"]["kernel"].T
        out[f"{prefix}.mlp.{name}.bias"] = tree[f"mlp_{name}"]["bias"]
    return out


def state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX CLIP param pytree (numpy leaves) -> OpenAI-layout state dict: the
    inverse of ``tise_tpu.backbones.clip_vit.params_from_openai_state_dict``
    (conv1 HWIO -> OIHW, Dense kernels transposed, ``proj``,
    ``text_projection`` and ``logit_scale`` as they are)."""
    p = params.get("params", params)
    vis, txt = p["visual"], p["text"]
    sd: Dict[str, np.ndarray] = {
        "visual.conv1.weight": np.transpose(np.asarray(vis["conv1"]["kernel"]), (3, 2, 0, 1)),
        "visual.class_embedding": vis["class_embedding"],
        "visual.positional_embedding": vis["positional_embedding"],
        "visual.ln_pre.weight": vis["ln_pre"]["scale"],
        "visual.ln_pre.bias": vis["ln_pre"]["bias"],
        "visual.ln_post.weight": vis["ln_post"]["scale"],
        "visual.ln_post.bias": vis["ln_post"]["bias"],
        "visual.proj": vis["proj"],
        "token_embedding.weight": txt["token_embedding"],
        "positional_embedding": txt["positional_embedding"],
        "ln_final.weight": txt["ln_final"]["scale"],
        "ln_final.bias": txt["ln_final"]["bias"],
        "text_projection": txt["text_projection"],
        "logit_scale": p["logit_scale"],
    }
    for tower, prefix in ((vis, "visual.transformer"), (txt, "transformer")):
        for name, block in tower["transformer"].items():
            sd.update(_block_state(block, f"{prefix}.resblocks.{name.split('_')[-1]}"))
    return {k: np.array(v, dtype=np.float32, order="C") for k, v in sd.items()}


def load_params(path: str) -> Dict[str, np.ndarray]:
    """OpenAI-layout state dict from an ``.npz`` (a JAX-package pytree, keys
    joined by '/', or an OpenAI-layout state dict saved with ``np.savez``) or
    an OpenAI ``.pt`` (a plain state dict, or the TorchScript archive that
    ``clip.load`` reads)."""
    from tise_tpu_torch.core import weights as weights_io

    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as f:
            flat = {k: f[k] for k in f.files}
        if any("/" in k for k in flat):
            return state_dict_from_jax_params(weights_io.unflatten_pytree(flat))
        return flat
    try:
        sd = weights_io.load_torch_state_dict(path)
    except RuntimeError:  # a TorchScript archive: torch.load refuses it, torch.jit.load reads it
        sd = {k: v.cpu().numpy() for k, v in torch.jit.load(path, map_location="cpu").state_dict().items()}
    return {k: v for k, v in sd.items() if k not in _META_KEYS}


def random_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random OpenAI-layout ViT-B/32 weights made with numpy from ``seed``
    (smoke runs and tests; real runs load a checkpoint).  The init of
    openai/CLIP ``initialize_parameters``: token embedding N(0, 0.02), text
    positions N(0, 0.01), image class and position embeddings N(0, width^-0.5),
    conv and image projection N(0, width^-0.5), attention in-proj
    N(0, width^-0.5), out-proj and c_proj N(0, width^-0.5 (2 layers)^-0.5),
    c_fc N(0, (2 width)^-0.5), biases 0, LayerNorm 1 and 0, logit scale
    log(1/0.07)."""
    with torch.device("meta"):
        model = CLIP()
    towers = {True: (model.visual.ln_pre.normalized_shape[0], len(model.visual.transformer.resblocks)),
              False: (model.ln_final.normalized_shape[0], len(model.transformer.resblocks))}
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        w, layers = towers[k.startswith("visual.")]
        if k == "logit_scale":
            out[k] = np.asarray(np.log(1 / 0.07), dtype=np.float32)
            continue
        if k.endswith("bias"):
            out[k] = np.zeros(shape, np.float32)
            continue
        if k.endswith("weight") and k.split(".")[-2].startswith("ln_"):
            out[k] = np.ones(shape, np.float32)
            continue
        if k == "token_embedding.weight":
            std = 0.02
        elif k == "positional_embedding":
            std = 0.01
        elif k.endswith(("out_proj.weight", "c_proj.weight")):
            std = w ** -0.5 * (2 * layers) ** -0.5
        elif k.endswith("c_fc.weight"):
            std = (2 * w) ** -0.5
        else:  # conv1, class and position embeddings, in_proj, proj, text_projection
            std = w ** -0.5
        out[k] = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
    return out
