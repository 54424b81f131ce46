"""What a run is made of, from its seed: weights, images, embeddings,
labels, JPEG files.

Every stream has its own generator, seeded from (--seed, a tag), so one
seed gives the same inputs in every run and in the reference. Weights and
images are drawn on the run's device in a few large calls.
"""
from __future__ import annotations

import hashlib
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench import trunks


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream `tag` of run seed `seed`."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))


def _scale(name: str, shape: tuple, cfg: dict, trunk) -> tuple[float, float]:
    """(offset, std) of a leaf drawn as offset + std * N(0, 1): the trunk
    module's own rule (`init_scale`) where it has one for the leaf, else
    matrices and kernels std 1/sqrt(fan_in), norm weights offset 1 and std
    0.1, biases std 0.1."""
    own = getattr(trunk, "init_scale", None)
    rule = own and own(name, shape, cfg)
    if rule is not None:
        return rule
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if name.endswith("weight"):
        return 1.0, 0.1
    return 0.0, 0.1


def make_weights(named_shapes: list, seed: int, device, cfg: dict) -> dict:
    """{name: f32 tensor} for [(name, shape)] of configuration `cfg`, from
    one normal draw on `device`."""
    trunk = trunks.get(cfg)
    total = sum(math.prod(s) for _, s in named_shapes)
    flat = torch.randn(total, generator=generator(seed, "weights", device),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in named_shapes:
        n = math.prod(shape)
        offset, std = _scale(name, shape, cfg, trunk)
        out[name] = flat[at:at + n].view(shape).mul_(std).add_(offset)
        at += n
    return out


def parameter_shapes(model: torch.nn.Module) -> list:
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def load_weights(model: torch.nn.Module, weights: dict) -> None:
    """Copy `weights` into the parameters of the same names; every name has
    to be one of the model's, with its shape."""
    params = dict(model.named_parameters())
    missing = [n for n in weights if n not in params]
    if missing:
        raise KeyError(f"{type(model).__name__} lacks {missing[:5]}")
    with torch.no_grad():
        for name, w in weights.items():
            if tuple(params[name].shape) != tuple(w.shape):
                raise ValueError(f"{name}: {tuple(params[name].shape)} "
                                 f"against {tuple(w.shape)}")
            params[name].copy_(w)


def make_split(cfg: dict, rows: int, seed: int, device, tag: str = "split"
               ) -> dict:
    """A split of `rows` seeded uint8 NHWC images, the two f32 embeddings
    and [rows, 2] int32 (style, genre) labels, as host numpy arrays (drawn
    on `device`)."""
    g = generator(seed, tag, device)
    s = cfg["img_size"]
    images = torch.randint(0, 256, (rows, s, s, 3), generator=g,
                           device=device, dtype=torch.uint8)
    emb = torch.randn((2, rows, cfg["emb_size"]), generator=g, device=device)
    labels = torch.stack([torch.randint(0, cfg["num_classes"][t], (rows,),
                                        generator=g, device=device)
                          for t in ("style", "genre")], 1).to(torch.int32)
    return {"images": images.cpu().numpy(), "emb_style": emb[0].cpu().numpy(),
            "emb_genre": emb[1].cpu().numpy(), "labels": labels.cpu().numpy()}


class ArraySplit:
    """A dataset over a split's arrays with the port's vectorized
    `get_batch` contract: (images, emb_style, emb_genre, labels)."""

    def __init__(self, split: dict):
        self.split = split

    def __len__(self) -> int:
        return len(self.split["images"])

    def get_batch(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        s = self.split
        return (s["images"][idx], s["emb_style"][idx], s["emb_genre"][idx],
                s["labels"][idx])


def structured_jpeg(path: str, seed: int, width: int, height: int,
                    quality: int) -> None:
    """A JPEG with the structure of a photograph (the port's chip_smoke
    phase-29 image): smooth per-channel waves, six flat rectangles, mild
    noise."""
    from PIL import Image

    r = np.random.default_rng(seed)
    ys = np.arange(height, dtype=np.float32)[:, None, None]
    xs = np.arange(width, dtype=np.float32)[None, :, None]
    f = r.uniform(0.002, 0.03, (2, 3)).astype(np.float32)
    ph = r.uniform(0, 6.28, (2, 3)).astype(np.float32)
    img = 128 + 60 * np.sin(ys * f[0] + ph[0]) + 60 * np.cos(xs * f[1]
                                                             + ph[1])
    for _ in range(6):
        y0, x0 = r.integers(0, height - 64), r.integers(0, width - 64)
        h, w = r.integers(32, 256, 2)
        img[y0:y0 + h, x0:x0 + w] = r.uniform(0, 255, 3)
    img = img + r.normal(0, 4, (height, width, 3)).astype(np.float32)
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
        path, quality=quality)


def write_jpegs(folder: str, count: int, seed: int, width: int, height: int,
                quality: int, workers: int) -> list:
    """`count` seeded JPEGs `img_<k>.jpg` in `folder`; their file names."""
    os.makedirs(folder, exist_ok=True)
    names = [f"img_{k}.jpg" for k in range(count)]
    seeds = rng(seed, "jpegs").integers(0, 2**62, count)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(lambda k: structured_jpeg(
            os.path.join(folder, names[k]), int(seeds[k]), width, height,
            quality), range(count)))
    return names
