"""Operations and bytes of the port's paths, from the configuration's
shapes alone (the yardstick: nothing here reads the program).

An operation is one multiply or one add (2 per multiply-accumulate). A
product's bytes count each input once and each output once, whatever the
kernel reads again. Tokens follow the deployed ToMe schedule where the
path merges (r 96, floor S/8: base-256 256 → 160 → 80 → 40 → 32).
"""

from __future__ import annotations

TOME_R = 96               # the deployed schedule (tpudf_torch.ops.tome)
TOME_FLOOR_DIV = 8
VIEWS_PER_IMAGE = 53      # the full analysis: 21 main views, 32 patch views
FREQ_VIEWS_PER_IMAGE = 34  # views whose frequency logits are used
FREQ_DIM, FREQ_HIDDEN = 24, 64


def shape(config: dict) -> dict:
    """The tower's sizes under short names, from the configuration file's
    (Hugging Face SiglipVisionConfig) keys."""
    s, p = config["image_size"], config["patch_size"]
    return {"W": config["hidden_size"], "M": config["intermediate_size"],
            "L": config["num_hidden_layers"],
            "H": config["num_attention_heads"], "S": s, "P": p,
            "N": (s // p) ** 2}


def tome_tokens(n: int, layers: int) -> list[int]:
    """The tokens entering each layer: after every block but the last,
    TOME_R pairs merge, clipped so the count stays >= max(8, n //
    TOME_FLOOR_DIV) and a multiple of 8 and no more than half merge."""
    floor = max(8, n // TOME_FLOOR_DIV)
    out, t = [], n
    for i in range(layers):
        out.append(t)
        if i < layers - 1:
            ri = min(TOME_R, max(0, t - floor), t // 2)
            t -= ri - ri % 8
    return out


def layer_products(t: int, w: int, m: int) -> list[tuple[int, int, int]]:
    """(rows, K, N) of a block's four projections over t tokens: qkv, the
    attention's out-projection, fc1 and fc2."""
    return [(t, w, 3 * w), (t, w, w), (t, w, m), (t, m, w)]


def mm_ops(products) -> int:
    return sum(2 * r * k * n for r, k, n in products)


def attention_ops(t: int, w: int) -> int:
    """Scores and weighted values of all heads over t tokens."""
    return 4 * t * t * w


def map_head_ops(t: int, w: int, m: int) -> int:
    """The MAP head: one probe query over t tokens, out-projection, MLP."""
    return (2 * w * w + 2 * t * w * 2 * w + 4 * t * w + 2 * w * w
            + 2 * w * m + 2 * m * w)


def binary_head_ops(w: int) -> int:
    """The v5 head: SE (w → w/16 → w), then w → w/2 → w/4 → 1."""
    return 2 * (2 * w * (w // 16) + w * (w // 2) + (w // 2) * (w // 4)
                + w // 4)


def freq_mlp_ops() -> int:
    return 2 * (FREQ_DIM * FREQ_HIDDEN + FREQ_HIDDEN)


def tower_ops(sz: dict, tokens: list[int], merges: bool) -> int:
    """Patch embedding, the blocks (projections and attention), the
    merges' similarity products and the MAP head of one image."""
    w, m, n = sz["W"], sz["M"], sz["N"]
    ops = 2 * n * (sz["P"] ** 2 * 3) * w
    for i, t in enumerate(tokens):
        ops += mm_ops(layer_products(t, w, m)) + attention_ops(t, w)
        if merges and i + 1 < len(tokens) and tokens[i + 1] < t:
            ops += 2 * ((t + 1) // 2) * (t // 2) * w
    return ops + map_head_ops(tokens[-1], w, m)


def detect_ops_per_image(config: dict) -> int:
    """The detect core of one image: the ToMe tower, the v5 head, the
    frequency MLP and the Linear(2 → 1) fusion."""
    sz = shape(config)
    tokens = tome_tokens(sz["N"], sz["L"])
    return (tower_ops(sz, tokens, True) + binary_head_ops(sz["W"])
            + freq_mlp_ops() + 2 * 2)


def detect_i8gemm_work(config: dict, batch: int):
    """({"int8": ops}, bytes) of one batch's int8 products (every block's
    four projections, on rows of batch · tokens): int8 codes in, int8
    weights once, outputs as the kernels store them (qkv and the residual
    sums bf16, the GELU hidden int8 codes), residuals read once, and each
    product's f32 column scales and bias."""
    sz = shape(config)
    w, m = sz["W"], sz["M"]
    ops = n_bytes = 0
    for t in tome_tokens(sz["N"], sz["L"]):
        rows = batch * t
        (r, k1, n1), (_, k2, n2), (_, k3, n3), (_, k4, n4) = \
            layer_products(rows, w, m)
        ops += mm_ops(layer_products(rows, w, m))
        n_bytes += (r * k1 + k1 * n1 + 2 * r * n1           # qkv
                    + r * k2 + k2 * n2 + 4 * r * n2          # out + res
                    + r * k3 + k3 * n3 + r * n3              # fc1 → int8
                    + r * k4 + k4 * n4 + 4 * r * n4          # fc2 + res
                    + 8 * (n1 + n2 + n3 + n4))
    return {"int8": ops}, n_bytes


def request_ops(config: dict, images: int) -> int:
    """The full analysis of `images` images: every view through the bf16
    tower (no ToMe), the v5 head on every view, the frequency MLP on the
    views whose logits are used. The view resampling is not counted."""
    sz = shape(config)
    views = VIEWS_PER_IMAGE * images
    tokens = [sz["N"]] * sz["L"]
    return (views * (tower_ops(sz, tokens, False) + binary_head_ops(sz["W"]))
            + FREQ_VIEWS_PER_IMAGE * images * freq_mlp_ops())


def request_bf16gemm_work(config: dict, images: int):
    """({"bf16": ops}, bytes) of the bf16 tower's block projections over a
    request's views: bf16 operands in, weights once, bf16 outputs, the
    residuals of the out-projection and fc2 read once, the f32 biases."""
    sz = shape(config)
    w, m, n = sz["W"], sz["M"], sz["N"]
    rows = VIEWS_PER_IMAGE * images * n
    prods = layer_products(rows, w, m)
    per_layer_bytes = sum(2 * (r * k + k * nn + r * nn) + 4 * nn
                          for r, k, nn in prods) + 2 * 2 * rows * w
    return ({"bf16": sz["L"] * mm_ops(prods)},
            sz["L"] * per_layer_bytes)


def mtl_ops_per_image(config: dict, image_size: int, freeze_below: int,
                      taps, embed_dim: int) -> int:
    """One training image of the MTL step: the frozen prefix's forward,
    the trainable blocks' and MAP head's forward and backward (backward =
    2 × forward, less the input gradient of the first trainable block's
    qkv product, which no leaf needs), the 3-class head, and the SegFormer
    decoder's products forward and backward (less the input gradients of
    the projections of taps inside the frozen prefix)."""
    sz = shape(dict(config, image_size=image_size))
    w, m, t, L = sz["W"], sz["M"], sz["N"], sz["L"]
    e, k, g, s = embed_dim, len(taps), (image_size // sz["P"]), image_size
    layer = mm_ops(layer_products(t, w, m)) + attention_ops(t, w)
    n_train = L - freeze_below
    ops = 2 * t * (sz["P"] ** 2 * 3) * w + L * layer
    if n_train > 0:
        ops += 2 * n_train * layer - 2 * t * w * 3 * w
    head = map_head_ops(t, w, m) + 2 * w * 3
    ops += 3 * head
    dec = (k * (2 * t * w * e + 2 * t * e * 9 + 2 * t * e * e)
           + 2 * t * (k * e) * (k * e // 4) * 2 + 2 * t * (k * e) * e
           + 2 * s * g * g * e + 2 * s * s * g * e + 2 * s * s * e)
    frozen_taps = sum(1 for i in taps if 0 <= i < freeze_below)
    return ops + 3 * dec - frozen_taps * 2 * t * e * w
