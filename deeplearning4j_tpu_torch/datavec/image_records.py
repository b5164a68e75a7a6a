"""A copy of `deeplearning4j_tpu/datavec/image_records.py`, with its imports on the
port's modules. Image record reading (≡ datavec-data-image ::
org.datavec.image.recordreader.ImageRecordReader +
loader.NativeImageLoader + transform.ImageTransform family +
api.io.labels.ParentPathLabelGenerator).

PIL decodes, imported at the call (the reference used JavaCV);
output is NHWC float32 batches, the layout every conv in this framework
consumes directly (no NCHW permute step like the reference's loader).
"""
from __future__ import annotations

import os

import numpy as np


class ParentPathLabelGenerator:
    """≡ ParentPathLabelGenerator — label = parent directory name."""

    def getLabelForPath(self, path):
        return os.path.basename(os.path.dirname(os.path.abspath(path)))


class ImageTransform:
    def transform(self, img_array, rng):
        raise NotImplementedError


class ResizeImageTransform(ImageTransform):
    def __init__(self, newHeight, newWidth):
        self.h, self.w = int(newHeight), int(newWidth)

    def transform(self, img, rng):
        from PIL import Image
        squeeze = img.ndim == 3 and img.shape[2] == 1
        src = img[:, :, 0] if squeeze else img   # PIL: gray is 2-D
        pil = Image.fromarray(src.astype(np.uint8))
        out = np.asarray(pil.resize((self.w, self.h)), np.float32)
        return out[:, :, None] if squeeze else out


class FlipImageTransform(ImageTransform):
    """Random horizontal flip (p=0.5)."""

    def transform(self, img, rng):
        return img[:, ::-1] if rng.random() < 0.5 else img


class CropImageTransform(ImageTransform):
    """Random crop by up to `crop` pixels per edge, then pad back."""

    def __init__(self, crop):
        self.crop = int(crop)

    def transform(self, img, rng):
        c = self.crop
        if c <= 0:
            return img
        top = rng.integers(0, c + 1)
        left = rng.integers(0, c + 1)
        h, w = img.shape[:2]
        out = img[top:h - (c - top) or h, left:w - (c - left) or w]
        pad = [(top, c - top), (left, c - left)] + \
            [(0, 0)] * (img.ndim - 2)
        return np.pad(out, pad, mode="edge")


class RotateImageTransform(ImageTransform):
    """≡ transform.RotateImageTransform(angle): rotate by a uniform random
    angle in [-angle, +angle] degrees about the image center (bilinear,
    same output size, edge value 0 — the reference's warpAffine
    default)."""

    def __init__(self, angle):
        self.angle = float(angle)

    def transform(self, img, rng):
        from PIL import Image
        deg = float(rng.uniform(-self.angle, self.angle))
        squeeze = img.ndim == 3 and img.shape[2] == 1
        src = img[:, :, 0] if squeeze else img
        pil = Image.fromarray(src.astype(np.uint8))
        out = np.asarray(pil.rotate(deg, resample=Image.BILINEAR,
                                    expand=False, fillcolor=0), np.float32)
        return out[:, :, None] if squeeze else out


class RandomCropTransform(ImageTransform):
    """≡ transform.RandomCropTransform(height, width): crop a random
    (height, width) window — the output is SMALLER than the input (the
    augmentation form of cropping, unlike CropImageTransform's
    crop-and-pad)."""

    def __init__(self, height, width):
        self.h, self.w = int(height), int(width)

    def transform(self, img, rng):
        h, w = img.shape[:2]
        if self.h > h or self.w > w:
            raise ValueError(
                f"RandomCropTransform({self.h}, {self.w}): crop larger "
                f"than the {h}x{w} input")
        top = int(rng.integers(0, h - self.h + 1))
        left = int(rng.integers(0, w - self.w + 1))
        return img[top:top + self.h, left:left + self.w]


class ColorConversionTransform(ImageTransform):
    """≡ transform.ColorConversionTransform: the common conversions by
    name instead of OpenCV integer codes — 'RGB2GRAY' (1 channel),
    'BGR2RGB'/'RGB2BGR' (channel reversal), 'RGB2HSV'/'HSV2RGB'."""

    _ITU_R = np.array([0.299, 0.587, 0.114], np.float32)  # BT.601 luma

    def __init__(self, conversion="RGB2GRAY"):
        conv = str(conversion).upper()
        if conv not in ("RGB2GRAY", "BGR2RGB", "RGB2BGR", "RGB2HSV",
                        "HSV2RGB"):
            raise ValueError(f"unsupported conversion {conversion!r}")
        self.conversion = conv

    def transform(self, img, rng):
        if img.ndim == 2:
            img = img[:, :, None]
        if self.conversion == "RGB2GRAY":
            if img.shape[2] == 1:
                return img
            if img.shape[2] < 3:
                raise ValueError(
                    f"RGB2GRAY needs 1 or >=3 channels, got "
                    f"{img.shape[2]}")
            return (img[:, :, :3] @ self._ITU_R)[:, :, None]
        if img.shape[2] != 3:
            # exactly 3: silently reversing RGBA would move alpha into a
            # color plane, and PIL's HSV path would die cryptically
            raise ValueError(
                f"{self.conversion} needs exactly 3 channels, got "
                f"{img.shape[2]} (slice [:, :, :3] first)")
        if self.conversion in ("BGR2RGB", "RGB2BGR"):
            return img[:, :, ::-1]
        from PIL import Image
        mode_in, mode_out = (("RGB", "HSV")
                             if self.conversion == "RGB2HSV"
                             else ("HSV", "RGB"))
        pil = Image.fromarray(img.astype(np.uint8), mode=mode_in)
        return np.asarray(pil.convert(mode_out), np.float32)


class PipelineImageTransform(ImageTransform):
    """≡ transform.PipelineImageTransform: a chain of transforms, each
    optionally gated by a probability — pass plain transforms or
    (transform, probability) pairs; shuffle=True applies them in a random
    order per image (the reference's shuffle flag)."""

    def __init__(self, *transforms, shuffle=False):
        self.transforms = [t if isinstance(t, tuple) else (t, 1.0)
                           for t in transforms]
        self.shuffle = bool(shuffle)

    def transform(self, img, rng):
        order = list(range(len(self.transforms)))
        if self.shuffle:
            rng.shuffle(order)
        for i in order:
            t, prob = self.transforms[i]
            if prob >= 1.0 or rng.random() < prob:
                img = t.transform(img, rng)
        return img


_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".gif", ".ppm"}


class ImageRecordReader:
    """≡ ImageRecordReader(height, width, channels, labelGenerator).

    initialize() walks a directory tree; next() yields
    [image (H,W,C) float32 0-255, label index].
    """

    def __init__(self, height, width, channels=3, labelGenerator=None,
                 imageTransform=None, seed=0, nativeLoader=False):
        self.height, self.width = int(height), int(width)
        self.channels = int(channels)
        self.labelGenerator = labelGenerator or ParentPathLabelGenerator()
        self.imageTransform = imageTransform
        self.nativeLoader = bool(nativeLoader)   # C++ bilinear resize
        self._rng = np.random.default_rng(seed)
        self._paths = []
        self._labels = []
        self._label_names = []
        self._idx = 0

    def initialize(self, path_or_split, shuffle=False):
        root = getattr(path_or_split, "rootDir", path_or_split)
        paths = []
        for dirpath, _, files in sorted(os.walk(str(root))):
            for fn in sorted(files):
                if os.path.splitext(fn)[1].lower() in _IMG_EXTS:
                    paths.append(os.path.join(dirpath, fn))
        if not paths:
            raise FileNotFoundError(f"no images under {root}")
        names = sorted({self.labelGenerator.getLabelForPath(p)
                        for p in paths})
        self._label_names = names
        lookup = {n: i for i, n in enumerate(names)}
        if shuffle:
            self._rng.shuffle(paths)
        self._paths = paths
        self._labels = [lookup[self.labelGenerator.getLabelForPath(p)]
                        for p in paths]
        self._idx = 0
        return self

    def getLabels(self):
        return list(self._label_names)

    def numExamples(self):
        return len(self._paths)

    def _load(self, path):
        if self.nativeLoader:
            arr = NativeImageLoader(self.height, self.width,
                                    self.channels).asMatrix(path)[0]
        else:
            from PIL import Image
            decoded = _pil_decode(path, self.channels)
            img = Image.fromarray(decoded).resize(
                (self.width, self.height))
            arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.imageTransform is not None:
            arr = self.imageTransform.transform(arr, self._rng)
            if arr.shape[:2] != (self.height, self.width):
                arr = ResizeImageTransform(
                    self.height, self.width).transform(arr, self._rng)
        return arr

    def hasNext(self):
        return self._idx < len(self._paths)

    def next(self):
        img = self._load(self._paths[self._idx])
        label = self._labels[self._idx]
        self._idx += 1
        return [img, label]

    def reset(self):
        self._idx = 0

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()


class ImageRecordDataSetIterator:
    """Bridge to DataSetIterator (≡ RecordReaderDataSetIterator over an
    ImageRecordReader): batches NHWC images + one-hot labels."""

    def __init__(self, reader, batch_size, num_classes=None,
                 preprocessor=None):
        self.reader = reader
        self.batch_size = int(batch_size)
        self.num_classes = num_classes or len(reader.getLabels())
        self.preprocessor = preprocessor

    def __iter__(self):
        self.reader.reset()
        while self.reader.hasNext():
            imgs, labels = [], []
            while self.reader.hasNext() and len(imgs) < self.batch_size:
                img, lab = self.reader.next()
                imgs.append(img)
                labels.append(lab)
            from deeplearning4j_tpu_torch.datasets.dataset import DataSet
            x = np.stack(imgs)
            y = np.eye(self.num_classes, dtype=np.float32)[labels]
            ds = DataSet(x, y)
            if self.preprocessor is not None:
                self.preprocessor.preProcess(ds)
            yield ds

    def reset(self):
        self.reader.reset()


def _pil_decode(path, channels):
    """ONE file-decode path (PIL open + mode convert) shared by
    ImageRecordReader and NativeImageLoader — decode fixes (EXIF,
    palettes, ...) must never diverge between the two."""
    from PIL import Image
    img = Image.open(path)
    return np.asarray(img.convert("RGB" if channels == 3 else "L"))


class NativeImageLoader:
    """≡ datavec-data-image :: loader.NativeImageLoader — decode + resize
    to (height, width, channels) float32 via the NATIVE runtime (C++
    bilinear in runtime/native; strict-parity-gated numpy oracle when the
    toolchain is absent — identical output either way). The reference is
    NCHW via JavaCV; this stack is NHWC-native, and asMatrix returns
    (1, H, W, C) ready for the conv layers."""

    def __init__(self, height, width, channels=3):
        self.height, self.width = int(height), int(width)
        self.channels = int(channels)

    def _decode(self, src):
        if isinstance(src, np.ndarray):
            arr = src
            if np.issubdtype(arr.dtype, np.floating):
                # [0, 1]-normalized floats scale back to [0, 255];
                # [0, 255] floats round — NEVER a silent truncating cast.
                # 1% slack each side absorbs bilinear/bicubic over/under-
                # shoot, scaled to the detected range; the final clip maps
                # undershoot to 0. Real [-1,1] images still fail loudly,
                # as does the ambiguous (1.01, 2.0) band (a scaled-up
                # normalized image would read near-black).
                mx = float(arr.max(initial=0.0))
                lo_tol = 1e-2 * (1.0 if mx <= 1.0 + 1e-2 else 255.0)
                if float(arr.min(initial=0.0)) < -lo_tol:
                    raise ValueError(
                        "NativeImageLoader: float image with negative "
                        "values is ambiguous ([-1,1]-normalized?) — "
                        "rescale to [0,1] or [0,255] first")
                if 1.0 + 1e-2 < mx < 2.0:
                    raise ValueError(
                        "NativeImageLoader: float image with max "
                        f"{mx:.4f} is ambiguous (overshot [0,1] or a "
                        "dim [0,255] image?) — rescale explicitly")
                scale = 255.0 if mx <= 1.0 + 1e-2 else 1.0
                arr = np.rint(
                    np.clip(arr.astype(np.float32) * scale, 0.0, 255.0))
        else:
            arr = _pil_decode(src, self.channels)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        have = arr.shape[-1]
        if have != self.channels:
            if self.channels == 1 and have >= 3:
                # luminance, same weights as the reference's grayscale
                arr = np.rint(
                    arr[..., :3].astype(np.float32)
                    @ np.array([0.299, 0.587, 0.114], np.float32)
                )[..., None]
            elif self.channels == 1 and have == 2:
                arr = arr[..., :1]           # LA: drop alpha
            elif self.channels == 3 and have == 1:
                arr = np.repeat(arr, 3, axis=-1)
            elif self.channels == 3 and have > 3:
                arr = arr[..., :3]           # RGBA: drop alpha
            else:
                raise ValueError(
                    f"NativeImageLoader: cannot map {have} "
                    f"channels to {self.channels}")
        return np.clip(arr, 0, 255).astype(np.uint8)

    def asMatrix(self, src):
        """path | (H, W[, C]) array → (1, height, width, channels) f32."""
        from deeplearning4j_tpu_torch.runtime.native_lib import resize_bilinear_u8
        u8 = self._decode(src)
        out = resize_bilinear_u8(u8, self.height, self.width)
        return out[None]

    def asImageMatrix(self, src):
        return self.asMatrix(src)
