"""Throughput-path InceptionV3 forward: the bf16 BN-folded trunk behind
``--precision fast`` (mirrors tise_tpu/backbones/inception_fast.py).

The module in backbones/inception_v3.py stays the f32 reference path; this
is the same network with two restructurings:

  * **BN folding at prep time** — BasicConv2d is conv + frozen BN + relu;
    the BN scale is folded into the conv kernel in f32 and the result cast
    once, which leaves one f32 bias + relu epilogue per conv.
  * **Combined 1x1 branch fan-out** — every Inception block feeds the same
    activation into 2-3 parallel 1x1 convs; their folded kernels are
    concatenated into ONE conv (the block input is read once) and the output
    is split by channel.  The pool branch's 1x1 joins the fan-out too: a
    stride-1 average pool and a 1x1 conv commute, so the pool runs on the
    branch's thin output (kernel K2, ``ops/fast_pool``) and the wide block
    input is never re-read for pooling.

The convolutions are the library's (cuDNN, ``channels_last``), as the JAX
package leaves them to XLA.  torch pool semantics only (the slim / tf2015
flavors keep the f32 module).  It takes the port's torchvision-layout
state dict.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tise_tpu_torch.backbones.inception_v3 import BN_EPS, ENDPOINTS
from tise_tpu_torch.ops.fast_pool import avg_pool_3x3_s1_p1
from tise_tpu_torch.ops.preprocess import RECIPES

Folded = Tuple[torch.Tensor, torch.Tensor]  # (kernel OIHW in the compute dtype, bias [cout] f32)

_SUFFIX = ".conv.weight"


def _fold(state: Mapping[str, np.ndarray], name: str, dtype, in_scale=None, in_shift=None) -> Folded:
    """One BasicConv2d of the state dict -> (BN-folded kernel, f32 bias).

    ``in_scale``/``in_shift`` fold an input affine x = u*s + t (a uint8
    normalize recipe) into the kernel and bias — exact algebra:
    conv(u*s + t) = conv_{k*s}(u) + sum_{hw,i} k*t (before the BN affine).
    """
    def f32(key):
        return torch.tensor(np.asarray(state[f"{name}.{key}"]), dtype=torch.float32)

    w = f32("conv.weight")
    inv = f32("bn.weight") * torch.rsqrt(f32("bn.running_var") + BN_EPS)
    b = f32("bn.bias") - f32("bn.running_mean") * inv
    if in_scale is not None:
        b = b + torch.einsum("oihw,i->o", w, torch.tensor(in_shift, dtype=torch.float32)) * inv
        w = w * torch.tensor(in_scale, dtype=torch.float32).view(1, -1, 1, 1)
    return (w * inv.view(-1, 1, 1, 1)).to(dtype), b


def fold_tree(state: Mapping[str, np.ndarray], dtype=torch.bfloat16,
              input_recipe: Optional[str] = None) -> Dict[str, object]:
    """state dict -> ``{"w": {conv name: (kernel, bias)}, "fc": (w [in, out], b) or None}``.

    ``input_recipe``: fold that uint8 normalize recipe (ops/preprocess
    RECIPES) into Conv2d_1a_3x3 — the forward then consumes RAW uint8 images.
    """
    w: Dict[str, Folded] = {}
    for key in state:
        if not key.endswith(_SUFFIX) or key.startswith("AuxLogits."):
            continue
        name = key[: -len(_SUFFIX)]
        if name == "Conv2d_1a_3x3" and input_recipe is not None:
            scale, shift = RECIPES[input_recipe]
            w[name] = _fold(state, name, dtype, in_scale=scale, in_shift=shift)
        else:
            w[name] = _fold(state, name, dtype)
    fc = None
    if "fc.weight" in state:
        fc = (torch.tensor(np.asarray(state["fc.weight"]), dtype=torch.float32).T.contiguous().to(dtype),
              torch.tensor(np.asarray(state["fc.bias"]), dtype=torch.float32))
    return {"w": w, "fc": fc}


def _epilogue(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 bias + relu, cast back to the compute dtype (NCHW view).  The add
    promotes a bf16 ``y`` to f32 in the same pass."""
    return torch.relu_(y + b.view(1, -1, 1, 1)).to(y.dtype)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class FastInception:
    """Pre-folded forward on one device.  ``state`` is the torchvision-layout
    state dict (or pass ``folded=`` a ``fold_tree`` result)."""

    def __init__(self, state: Optional[Mapping[str, np.ndarray]] = None, dtype=torch.bfloat16, *,
                 folded: Optional[Dict[str, object]] = None, input_recipe: Optional[str] = None, device="cpu"):
        self.dtype = dtype
        self.device = torch.device(device)
        if folded is None:
            folded = fold_tree(state, dtype, input_recipe)
        self.w: Dict[str, Folded] = {
            k: (w.to(self.device).contiguous(memory_format=torch.channels_last), b.to(self.device))
            for k, (w, b) in folded["w"].items()
        }
        self.fc = None if folded["fc"] is None else tuple(t.to(self.device) for t in folded["fc"])
        #: informational: when the fold consumed a recipe, __call__ expects
        #: RAW uint8 (the affine lives in the conv1a weights)
        self.input_recipe = input_recipe
        self._fan: Dict[Tuple[str, ...], Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]] = {}

    # -- blocks -------------------------------------------------------------

    def _conv(self, x, name: str, stride=1, padding=0):
        w, b = self.w[name]
        return _epilogue(F.conv2d(x, w, None, stride, padding), b)

    def _cat(self, names: Tuple[str, ...]):
        """Concatenated folded 1x1 kernels and biases of several branches
        (built once per block and kept)."""
        if names not in self._fan:
            ws, bs = zip(*(self.w[n] for n in names))
            w = torch.cat(ws, 0).contiguous(memory_format=torch.channels_last)
            self._fan[names] = (w, torch.cat(bs, 0), tuple(t.shape[0] for t in ws))
        return self._fan[names]

    def _fanout(self, x, names: Sequence[str], pool_name: Optional[str] = None):
        """One combined 1x1 conv for all branch heads (x read once).

        ``pool_name``: the avg-pool branch's 1x1.  Its slice of the conv
        output is pooled in f32 (kernel K2 on the card), the bias is added
        AFTER the pool (zero edge padding would otherwise average the bias
        with count < 9) and relu after that; the same algebra as
        conv(pool(x)) to f32 exactness.
        """
        all_names = tuple(names) + ((pool_name,) if pool_name else ())
        w, b, sizes = self._cat(all_names)
        # the conv output stays in the compute dtype; the f32 bias + relu
        # epilogue runs per slice
        parts = torch.split(F.conv2d(x, w), sizes, dim=1)
        biases = torch.split(b, sizes)
        outs = [_epilogue(parts[i], biases[i]) for i in range(len(names))]
        if pool_name:
            thin = parts[-1].permute(0, 2, 3, 1).to(torch.float32, memory_format=torch.contiguous_format)
            pooled = avg_pool_3x3_s1_p1(thin, count_include_pad=True)  # NHWC f32
            outs.append(torch.relu_(pooled + biases[-1]).to(x.dtype).permute(0, 3, 1, 2))
        return outs

    def _block_a(self, x, m: str):
        b1, b5, b3, bp = self._fanout(
            x, (f"{m}.branch1x1", f"{m}.branch5x5_1", f"{m}.branch3x3dbl_1"), pool_name=f"{m}.branch_pool")
        b5 = self._conv(b5, f"{m}.branch5x5_2", padding=2)
        b3 = self._conv(self._conv(b3, f"{m}.branch3x3dbl_2", padding=1), f"{m}.branch3x3dbl_3", padding=1)
        return torch.cat([b1, b5, b3, bp], 1)

    def _block_b(self, x, m: str):
        b3 = self._conv(x, f"{m}.branch3x3", stride=2)
        bd = self._conv(self._conv(x, f"{m}.branch3x3dbl_1"), f"{m}.branch3x3dbl_2", padding=1)
        bd = self._conv(bd, f"{m}.branch3x3dbl_3", stride=2)
        return torch.cat([b3, bd, _max_pool(x)], 1)

    def _block_c(self, x, m: str):
        b1, b7, bd, bp = self._fanout(
            x, (f"{m}.branch1x1", f"{m}.branch7x7_1", f"{m}.branch7x7dbl_1"), pool_name=f"{m}.branch_pool")
        b7 = self._conv(b7, f"{m}.branch7x7_2", padding=(0, 3))
        b7 = self._conv(b7, f"{m}.branch7x7_3", padding=(3, 0))
        for name, pad in (("branch7x7dbl_2", (3, 0)), ("branch7x7dbl_3", (0, 3)),
                          ("branch7x7dbl_4", (3, 0)), ("branch7x7dbl_5", (0, 3))):
            bd = self._conv(bd, f"{m}.{name}", padding=pad)
        return torch.cat([b1, b7, bd, bp], 1)

    def _block_d(self, x, m: str):
        b3, b7 = self._fanout(x, (f"{m}.branch3x3_1", f"{m}.branch7x7x3_1"))
        b3 = self._conv(b3, f"{m}.branch3x3_2", stride=2)
        b7 = self._conv(b7, f"{m}.branch7x7x3_2", padding=(0, 3))
        b7 = self._conv(b7, f"{m}.branch7x7x3_3", padding=(3, 0))
        b7 = self._conv(b7, f"{m}.branch7x7x3_4", stride=2)
        return torch.cat([b3, b7, _max_pool(x)], 1)

    def _block_e(self, x, m: str):
        b1, b3, bd, bp = self._fanout(
            x, (f"{m}.branch1x1", f"{m}.branch3x3_1", f"{m}.branch3x3dbl_1"), pool_name=f"{m}.branch_pool")
        b3 = torch.cat([self._conv(b3, f"{m}.branch3x3_2a", padding=(0, 1)),
                        self._conv(b3, f"{m}.branch3x3_2b", padding=(1, 0))], 1)
        bd = self._conv(bd, f"{m}.branch3x3dbl_2", padding=1)
        bd = torch.cat([self._conv(bd, f"{m}.branch3x3dbl_3a", padding=(0, 1)),
                        self._conv(bd, f"{m}.branch3x3dbl_3b", padding=(1, 0))], 1)
        return torch.cat([b1, b3, bd, bp], 1)

    # -- trunk --------------------------------------------------------------

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, endpoints: Sequence[str] = ("pool3",)) -> Dict[str, torch.Tensor]:
        """x: NHWC [B, H, W, 3], float (or raw uint8 under ``input_recipe``)
        -> {endpoint: NHWC feature map or [B, D]} in the compute dtype."""
        want = set(endpoints)
        for e in want:
            if e not in ENDPOINTS:
                raise ValueError(f"unknown endpoint {e}")
        last = max(ENDPOINTS.index(e) for e in want)
        out: Dict[str, torch.Tensor] = {}

        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self._conv(x, "Conv2d_1a_3x3", stride=2)
        x = self._conv(x, "Conv2d_2a_3x3")
        x = self._conv(x, "Conv2d_2b_3x3", padding=1)
        x = _max_pool(x)
        out["maxpool1"] = x.permute(0, 2, 3, 1)
        if last == 0:
            return out

        x = self._conv(self._conv(x, "Conv2d_3b_1x1"), "Conv2d_4a_3x3")
        x = _max_pool(x)
        out["maxpool2"] = x.permute(0, 2, 3, 1)
        if last == 1:
            return out

        for m in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._block_a(x, m)
        x = self._block_b(x, "Mixed_6a")
        for m in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._block_c(x, m)
        out["mixed6e"] = x.permute(0, 2, 3, 1)
        if last == 2:
            return out

        x = self._block_d(x, "Mixed_7a")
        x = self._block_e(x, "Mixed_7b")
        x = self._block_e(x, "Mixed_7c")
        x = torch.mean(x.float(), dim=(2, 3)).to(self.dtype)
        out["pool3"] = x
        if last == 3:
            return out

        w, b = self.fc
        out["logits"] = ((x @ w).float() + b).to(self.dtype)
        return out
