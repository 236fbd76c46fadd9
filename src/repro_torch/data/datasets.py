"""Real-image datasets (MNIST, SVHN, CelebA) behind the ``ShardedLoader``
contract: a numpy-only copy of the reference's ``repro/data/datasets.py``,
so the port trains on the same rows without importing the JAX package.

The paper's generative-image experiments (§4.2, Fig. 4) run on MNIST, SVHN
and CelebA; this module supplies those inputs to the training/serving stack
without changing any loader plumbing: every dataset resolves to plain numpy
arrays plus a ``make_batch(step, shard, per_host)`` function -- the same
stateless contract ``repro_torch.data.pipeline.ShardedLoader`` enforces for
synthetic data, so restart/straggler recovery and disjoint sharding come for
free.

Three sources, resolved in order by :func:`load_image_dataset`:

  1. **npz cache** (``<data_dir>/<name>.npz``) -- one file per dataset, raw
     uint8 + labels, written once after the first download.
  2. **download** -- urllib against the canonical mirrors (MNIST IDX files,
     SVHN .mat via ``scipy.io``; CelebA has no anonymous mirror, so its
     "download" builds the cache from a locally provided raw copy -- see
     ``_fetch_celeba``).  Never attempted when ``source="procedural"``.
  3. **procedural fallback** -- a deterministic generator with the *same
     shapes, dtypes, splits and API* as the real dataset (class-conditional
     bump templates + jitter, quantized to uint8), so tests, CI and the
     ``--smoke`` paths never need network and still exercise every byte of
     the image plumbing.

Leaf-family domain transforms (:func:`to_domain`) map raw uint8 to the input
domain each exponential family models, and carry the change-of-variables
offset that a bits-per-dim metric (the reference's
``repro.eval.metrics.bits_per_dim``) needs:

  * ``normal``      -- x / 255 in [0, 1]; bpd offset log2(256) = 8 bits/dim
                       (the paper's continuous treatment of 8-bit data).
  * ``binomial``    -- raw counts 0..255 (N=255 trials); discrete, offset 0.
  * ``categorical`` -- raw levels 0..255; discrete, offset 0.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
import urllib.request
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.data.pipeline import ShardedLoader

DEFAULT_DATA_DIR = "artifacts/datasets"

# fraction of the train split carved off (deterministically, from the end)
# as the validation split -- the paper's protocol of model selection on
# held-out data without touching the test set.
VALID_FRACTION = 0.1


@dataclasses.dataclass(frozen=True)
class ImageSpec:
    """Static description of one image dataset."""

    name: str
    height: int
    width: int
    channels: int
    num_classes: int
    train_size: int  # canonical sizes (procedural fallback matches them
    test_size: int   # scaled down via the ``size_cap`` argument)

    @property
    def num_dims(self) -> int:
        return self.height * self.width * self.channels


SPECS: Dict[str, ImageSpec] = {
    "mnist": ImageSpec("mnist", 28, 28, 1, 10, 60_000, 10_000),
    "svhn": ImageSpec("svhn", 32, 32, 3, 10, 73_257, 26_032),
    # §4.2's mixture-of-EiNets dataset, center-cropped + downsampled to a
    # 32x32 PD grid (aligned CelebA is 178x218; the paper downsamples too).
    # CelebA has no class label; num_classes=1 (the attribute table is not
    # part of the density-estimation protocol).  Sizes follow the standard
    # partition file (train 162,770 / valid 19,867 / test 19,962).
    "celeba": ImageSpec("celeba", 32, 32, 3, 1, 162_770, 19_962),
}

# canonical mirrors; MNIST IDX files are gzip'd, SVHN is a MATLAB .mat
_MNIST_BASE = "https://ossci-datasets.s3.amazonaws.com/mnist/"
_MNIST_FILES = {
    "train_x": "train-images-idx3-ubyte.gz",
    "train_y": "train-labels-idx1-ubyte.gz",
    "test_x": "t10k-images-idx3-ubyte.gz",
    "test_y": "t10k-labels-idx1-ubyte.gz",
}
_SVHN_BASE = "http://ufldl.stanford.edu/housenumbers/"
_SVHN_FILES = {"train": "train_32x32.mat", "test": "test_32x32.mat"}


class DatasetUnavailable(RuntimeError):
    """No cache and the download failed (offline host)."""


@dataclasses.dataclass
class ImageDataset:
    """Loaded dataset: raw uint8 images (N, H, W, C) + int labels per split."""

    spec: ImageSpec
    train_x: np.ndarray
    train_y: np.ndarray
    valid_x: np.ndarray
    valid_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    source: str  # "cache" | "download" | "procedural"

    def split(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        if name not in ("train", "valid", "test"):
            raise KeyError(f"unknown split {name!r}; train/valid/test")
        return getattr(self, f"{name}_x"), getattr(self, f"{name}_y")


# ---------------------------------------------------------------- transforms
def to_domain(x_uint8: np.ndarray, family: str) -> Tuple[np.ndarray, float]:
    """uint8 images -> (flattened float32 batch in the EF domain, bpd offset).

    The offset is the per-dimension change-of-variables term (in bits) that
    converts the model's log-density back to bits-per-dim of the original
    8-bit data: discrete families model the levels directly (offset 0);
    ``normal`` models x/255 on [0, 1], so each dim picks up log2(256) bits.
    """
    flat = x_uint8.reshape(len(x_uint8), -1).astype(np.float32)
    if family == "normal":
        return flat / 255.0, float(np.log2(256.0))
    if family in ("binomial", "categorical"):
        return flat, 0.0
    raise ValueError(
        f"no image domain transform for leaf family {family!r}"
    )


# ------------------------------------------------------------------- loaders
def array_loader(
    data: np.ndarray,
    global_batch: int,
    num_shards: int = 1,
    shard_id: int = 0,
    start_step: int = 0,
) -> ShardedLoader:
    """Deterministic array-backed loader: shard ``sh`` of step ``s`` reads the
    contiguous row block ``[(s * num_shards + sh) * n, ...)`` (mod data), so
    shards within a step are DISJOINT and steps tile the dataset.
    """

    def make(step: int, shard: int, n: int) -> Dict[str, np.ndarray]:
        base = (step * num_shards + shard) * n
        return {"x": data[(np.arange(n) + base) % len(data)]}

    return ShardedLoader(
        make, global_batch, num_shards=num_shards, shard_id=shard_id,
        start_step=start_step,
    )


def image_loader(
    dataset: ImageDataset,
    split: str,
    global_batch: int,
    family: str = "normal",
    num_shards: int = 1,
    shard_id: int = 0,
    start_step: int = 0,
) -> ShardedLoader:
    """``ShardedLoader`` over one split, transformed to the leaf-EF domain."""
    x, _ = dataset.split(split)
    data, _ = to_domain(x, family)
    return array_loader(
        data, global_batch, num_shards=num_shards, shard_id=shard_id,
        start_step=start_step,
    )


# ----------------------------------------------------------------- downloads
def _download(url: str, path: str, timeout: float = 60.0) -> None:
    tmp = path + ".tmp"
    with urllib.request.urlopen(url, timeout=timeout) as r, open(tmp, "wb") as f:
        f.write(r.read())
    os.replace(tmp, path)


def _parse_idx(path: str) -> np.ndarray:
    """MNIST IDX format: big-endian magic + dims header, then raw uint8."""
    with gzip.open(path, "rb") as f:
        raw = f.read()
    _, _, dtype_code, ndim = struct.unpack(">BBBB", raw[:4])
    assert dtype_code == 0x08, f"expected uint8 IDX payload, got {dtype_code:#x}"
    dims = struct.unpack(">" + "I" * ndim, raw[4: 4 + 4 * ndim])
    return np.frombuffer(raw[4 + 4 * ndim:], dtype=np.uint8).reshape(dims)


def _fetch_mnist(data_dir: str, force: bool = False) -> Dict[str, np.ndarray]:
    out = {}
    for key, fname in _MNIST_FILES.items():
        path = os.path.join(data_dir, fname)
        if force or not os.path.isfile(path):
            _download(_MNIST_BASE + fname, path)
        out[key] = _parse_idx(path)
    return {
        "train_x": out["train_x"][..., None],  # (N, 28, 28, 1)
        "train_y": out["train_y"].astype(np.int32),
        "test_x": out["test_x"][..., None],
        "test_y": out["test_y"].astype(np.int32),
    }


def _fetch_svhn(data_dir: str, force: bool = False) -> Dict[str, np.ndarray]:
    from scipy import io as sio  # container ships scipy

    out = {}
    for split, fname in _SVHN_FILES.items():
        path = os.path.join(data_dir, fname)
        if force or not os.path.isfile(path):
            _download(_SVHN_BASE + fname, path)
        mat = sio.loadmat(path)
        # .mat layout is (H, W, C, N); label "10" means digit 0
        x = np.transpose(mat["X"], (3, 0, 1, 2)).astype(np.uint8)
        y = mat["y"].reshape(-1).astype(np.int32) % 10
        out[f"{split}_x"], out[f"{split}_y"] = x, y
    return out


def _fetch_celeba(data_dir: str, force: bool = False) -> Dict[str, np.ndarray]:
    """CelebA has NO anonymous direct-download mirror (the canonical copy
    sits behind Google-Drive auth), so "download" here means *build the npz
    cache from a locally provided raw copy*:

        <data_dir>/celeba_raw/img_align_celeba/*.jpg     (aligned 178x218)
        <data_dir>/celeba_raw/list_eval_partition.txt    (optional)

    Images are center-cropped to 178x178 and resized to the 32x32 spec with
    PIL; the partition file (0 train / 1 valid / 2 test) drives the split
    when present (0+1 fold into train -- ``_make_splits`` re-carves the
    validation tail), else the standard ordering does.  Raises when the raw
    directory is absent; offline callers use ``source="procedural"``.
    """
    from PIL import Image

    spec = SPECS["celeba"]
    raw = os.path.join(data_dir, "celeba_raw")
    img_dir = os.path.join(raw, "img_align_celeba")
    if not os.path.isdir(img_dir):
        raise FileNotFoundError(
            f"celeba: no raw copy at {img_dir}; CelebA is not anonymously "
            "downloadable -- place the aligned jpgs there (plus "
            "list_eval_partition.txt) or pass source='procedural'"
        )
    names = sorted(
        f for f in os.listdir(img_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    part_path = os.path.join(raw, "list_eval_partition.txt")
    parts = {}
    if os.path.isfile(part_path):
        with open(part_path) as f:
            for line in f:
                cols = line.split()
                if len(cols) >= 2:
                    parts[cols[0]] = int(cols[1])
    train, test = [], []
    for name in names:
        with Image.open(os.path.join(img_dir, name)) as im:
            im = im.convert("RGB")
            side = min(im.size)
            left = (im.size[0] - side) // 2
            top = (im.size[1] - side) // 2
            im = im.crop((left, top, left + side, top + side)).resize(
                (spec.width, spec.height), Image.BILINEAR
            )
            arr = np.asarray(im, np.uint8)
        (test if parts.get(name, 0) == 2 else train).append(arr)
    if not train or not test:
        # no/partial partition table: deterministic 9:1 tail split
        both = train + test
        n_test = max(1, len(both) // 10)
        train, test = both[:-n_test], both[-n_test:]
    zeros = lambda n: np.zeros(n, np.int32)  # noqa: E731 -- unlabeled
    return {
        "train_x": np.stack(train),
        "train_y": zeros(len(train)),
        "test_x": np.stack(test),
        "test_y": zeros(len(test)),
    }


_FETCHERS = {"mnist": _fetch_mnist, "svhn": _fetch_svhn,
             "celeba": _fetch_celeba}


# -------------------------------------------------------- procedural fallback
def procedural_images(
    spec: ImageSpec, num: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic stand-in with the real dataset's shapes/dtypes.

    Class-conditional templates (a fixed set of 2D Gaussian bumps per class,
    positions derived from the class id) plus per-sample geometric jitter and
    pixel noise, quantized to uint8 -- enough correlation structure that EM
    learns something and inpainting is visually checkable, with zero I/O.
    """
    h, w, c = spec.height, spec.width, spec.channels
    # crc32, NOT hash(): str hashes are salted per process (PYTHONHASHSEED),
    # and the fallback's whole point is cross-process reproducibility --
    # restart recovery and train-then-eval must see the same rows
    name_key = zlib.crc32(spec.name.encode())
    rng = np.random.RandomState((name_key + seed * 7919) % 2**31)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    templates = np.zeros((spec.num_classes, h, w, c), np.float32)
    for cls in range(spec.num_classes):
        trng = np.random.RandomState(1000 + cls)
        img = np.zeros((h, w, c), np.float32)
        for _ in range(3 + cls % 3):
            cy, cx = trng.rand(2) * [h * 0.8, w * 0.8] + [h * 0.1, w * 0.1]
            s = 1.5 + trng.rand() * (min(h, w) / 6.0)
            bump = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)))
            img += bump[:, :, None] * (0.4 + 0.6 * trng.rand(c))
        templates[cls] = img / max(img.max(), 1e-6)
    labels = rng.randint(spec.num_classes, size=num).astype(np.int32)
    # per-sample sub-pixel shift via a small random translation of the grid
    dy = rng.randint(-2, 3, size=num)
    dx = rng.randint(-2, 3, size=num)
    base = templates[labels]  # (N, H, W, C)
    shifted = np.empty_like(base)
    for i in range(num):  # cheap: N is test/CI sized
        shifted[i] = np.roll(base[i], (dy[i], dx[i]), axis=(0, 1))
    noisy = shifted * (0.85 + 0.15 * rng.rand(num, 1, 1, 1)) \
        + rng.randn(num, h, w, c).astype(np.float32) * 0.04
    return (np.clip(noisy, 0.0, 1.0) * 255.0).astype(np.uint8), labels


# ------------------------------------------------------------------- loading
def _make_splits(
    spec: ImageSpec,
    train_x: np.ndarray,
    train_y: np.ndarray,
    test_x: np.ndarray,
    test_y: np.ndarray,
    source: str,
) -> ImageDataset:
    n_valid = max(1, int(len(train_x) * VALID_FRACTION))
    return ImageDataset(
        spec=spec,
        train_x=train_x[:-n_valid],
        train_y=train_y[:-n_valid],
        valid_x=train_x[-n_valid:],
        valid_y=train_y[-n_valid:],
        test_x=test_x,
        test_y=test_y,
        source=source,
    )


def load_image_dataset(
    name: str,
    data_dir: str = DEFAULT_DATA_DIR,
    source: str = "auto",
    size_cap: Optional[int] = None,
) -> ImageDataset:
    """Resolve a dataset: cache -> download -> error, or procedural.

    Args:
      name: "mnist" | "svhn" | "celeba".
      data_dir: on-disk cache root (one ``<name>.npz`` per dataset).
      source: "auto" (cache, then download), "download" (re-download the
        raw files even if present and rebuild the npz cache), or
        "procedural" (deterministic offline fallback -- never touches disk
        or network).
      size_cap: optionally cap the train/test sizes (procedural and cached
        reads both honour it; keeps CI memory bounded).

    Raises:
      DatasetUnavailable: source="auto"/"download" with no cache and no
        network -- callers that must run offline pass source="procedural".
    """
    spec = SPECS.get(name)
    if spec is None:
        raise KeyError(f"unknown image dataset {name!r}; one of {list(SPECS)}")

    if source == "procedural":
        n_train = min(spec.train_size, size_cap or 4096)
        n_test = min(spec.test_size, max((size_cap or 4096) // 4, 64))
        train_x, train_y = procedural_images(spec, n_train, seed=0)
        test_x, test_y = procedural_images(spec, n_test, seed=1)
        return _make_splits(spec, train_x, train_y, test_x, test_y,
                            "procedural")
    if source not in ("auto", "download"):
        raise ValueError(
            f"unknown source {source!r}; auto/download/procedural"
        )

    cache = os.path.join(data_dir, f"{name}.npz")
    if source == "auto" and os.path.isfile(cache):
        z = np.load(cache)
        arrays = {k: z[k] for k in ("train_x", "train_y", "test_x", "test_y")}
        src = "cache"
    else:
        os.makedirs(data_dir, exist_ok=True)
        try:
            arrays = _FETCHERS[name](data_dir, force=source == "download")
        except Exception as e:  # no network on this host
            raise DatasetUnavailable(
                f"{name}: no cache at {cache} and download failed ({e}); "
                "pass source='procedural' for the offline fallback"
            ) from e
        np.savez_compressed(cache + ".tmp.npz", **arrays)
        os.replace(cache + ".tmp.npz", cache)
        src = "download"
    if size_cap is not None:
        arrays = {
            "train_x": arrays["train_x"][:size_cap],
            "train_y": arrays["train_y"][:size_cap],
            "test_x": arrays["test_x"][: max(size_cap // 4, 64)],
            "test_y": arrays["test_y"][: max(size_cap // 4, 64)],
        }
    return _make_splits(
        spec, arrays["train_x"], arrays["train_y"], arrays["test_x"],
        arrays["test_y"], src,
    )


def synthetic_image_dataset(
    height: int = 16,
    width: int = 16,
    channels: int = 3,
    num_train: int = 4096,
    num_test: int = 512,
    seed: int = 0,
) -> ImageDataset:
    """The synthetic mixture images (``repro_torch.data.synthetic``) wrapped in the
    ImageDataset API, so the eval workbench treats ``--dataset synthetic``
    exactly like a real dataset (uint8 storage, same splits/transforms)."""
    from repro_torch.data.synthetic import gaussian_mixture_images

    spec = ImageSpec("synthetic", height, width, channels, 10,
                     num_train, num_test)
    data = gaussian_mixture_images(
        num_train + num_test, height, width, channels, seed=seed
    )
    imgs = (data.reshape(-1, height, width, channels) * 255.0).astype(np.uint8)
    labels = np.zeros(len(imgs), np.int32)
    return _make_splits(
        spec, imgs[:num_train], labels[:num_train], imgs[num_train:],
        labels[num_train:], "procedural",
    )
