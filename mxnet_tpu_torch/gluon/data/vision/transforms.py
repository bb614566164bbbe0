"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``; parity:
python/mxnet/gluon/data/vision/transforms.py). Images are HWC NDArrays;
``ToTensor`` makes them CHW float32 in [0, 1]. The random transforms
draw from numpy's global generator, as the JAX package's do, so a seeded
run takes the same draws in both packages. ``Resize`` is bilinear with
antialiasing (``F.interpolate(antialias=True)``) or nearest with
half-pixel centers, as ``jax.image.resize`` is.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .... import ndarray as nd
from ...block import Block, HybridBlock
from ...nn.basic_layers import Sequential, HybridSequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting", "RandomGray", "CropResize"]

_GRAY = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def _const(values, like):
    """A constant NDArray on the device of ``like``."""
    return nd.array(np.asarray(values, np.float32), ctx=like.context)


class Compose(Sequential):
    """Sequentially composed transforms (reference: transforms.py:36);
    runs of HybridBlocks are grouped and hybridized."""

    def __init__(self, transforms):
        super().__init__()
        transforms.append(None)
        hybrid = []
        for i in transforms:
            if isinstance(i, HybridBlock):
                hybrid.append(i)
                continue
            if len(hybrid) == 1:
                self.add(hybrid[0])
                hybrid = []
            elif len(hybrid) > 1:
                hblock = HybridSequential()
                for j in hybrid:
                    hblock.add(j)
                hblock.hybridize()
                self.add(hblock)
                hybrid = []
            if i is not None:
                self.add(i)


class Cast(HybridBlock):
    def __init__(self, dtype='float32'):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.Cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 -> CHW float32/255 (reference: transforms.py:89)."""

    def __init__(self):
        super().__init__()

    def hybrid_forward(self, F, x):
        x = F.Cast(x, dtype='float32') / 255.0
        if hasattr(x, "ndim") and x.ndim == 4:
            return F.transpose(x, axes=(0, 3, 1, 2))
        return F.transpose(x, axes=(2, 0, 1))


class Normalize(Block):
    """(x - mean) / std on CHW tensors (reference: transforms.py:139)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, dtype=np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, dtype=np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        mean, std = _const(self._mean, x), _const(self._std, x)
        if x.ndim == 4:
            mean = mean.expand_dims(0)
            std = std.expand_dims(0)
        return (x - mean) / std


class Resize(Block):
    """Resize an HWC image to (w, h) (reference: transforms.py:235)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        if isinstance(self._size, int):
            if self._keep:
                h, w = x.shape[0], x.shape[1]
                if w < h:
                    new_w, new_h = self._size, int(h * self._size / w)
                else:
                    new_w, new_h = int(w * self._size / h), self._size
            else:
                new_w = new_h = self._size
        else:
            new_w, new_h = self._size
        img = x._data.to(torch.float32).permute(2, 0, 1)[None]
        if self._interpolation == 1:
            out = F.interpolate(img, size=(new_h, new_w), mode="bilinear",
                                align_corners=False, antialias=True)
        else:
            out = F.interpolate(img, size=(new_h, new_w),
                                mode="nearest-exact")
        return nd.NDArray(out[0].permute(1, 2, 0).to(x._data.dtype))


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        y0 = max((H - h) // 2, 0)
        x0 = max((W - w) // 2, 0)
        return x[y0:y0 + h, x0:x0 + w]


class CropResize(Block):
    def __init__(self, x, y, width, height, size=None, interpolation=None):
        super().__init__()
        self._x, self._y = x, y
        self._w, self._h = width, height
        self._size = size
        self._interp = interpolation

    def forward(self, data):
        out = data[self._y:self._y + self._h, self._x:self._x + self._w]
        if self._size:
            out = Resize(self._size, interpolation=self._interp or 1)(out)
        return out


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.), ratio=(3. / 4., 4. / 3.),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        H, W = x.shape[0], x.shape[1]
        area = H * W
        resize = Resize(self._size, interpolation=self._interpolation)
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            aspect = np.random.uniform(*self._ratio)
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                x0 = np.random.randint(0, W - w + 1)
                y0 = np.random.randint(0, H - h + 1)
                return resize(x[y0:y0 + h, x0:x0 + w])
        return resize(CenterCrop((min(H, W), min(H, W)))(x))


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return x.flip(axis=1)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return x.flip(axis=0)
        return x


class _RandomJitter(Block):
    def __init__(self, factor):
        super().__init__()
        self._factor = max(0.0, float(factor))

    def _alpha(self):
        return 1.0 + np.random.uniform(-self._factor, self._factor)


class RandomBrightness(_RandomJitter):
    def forward(self, x):
        return (x.astype('float32') * self._alpha()).clip(0, 255)


class RandomContrast(_RandomJitter):
    def forward(self, x):
        alpha = self._alpha()
        xf = x.astype('float32')
        gray_mean = float((xf * _const(_GRAY, x)).sum().asscalar()) / (
            x.shape[0] * x.shape[1])
        return (xf * alpha + gray_mean * (1 - alpha)).clip(0, 255)


class RandomSaturation(_RandomJitter):
    def forward(self, x):
        alpha = self._alpha()
        xf = x.astype('float32')
        gray = (xf * _const(_GRAY, x)).sum(axis=2, keepdims=True)
        return (xf * alpha + gray * (1 - alpha)).clip(0, 255)


class RandomHue(_RandomJitter):
    def forward(self, x):
        # channel rotation in YIQ space
        alpha = np.random.uniform(-self._factor, self._factor) * np.pi
        u, w = np.cos(alpha), np.sin(alpha)
        t_yiq = np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], dtype=np.float32)
        t_rgb = np.linalg.inv(t_yiq).astype(np.float32)
        rot = np.array([[1, 0, 0], [0, u, -w], [0, w, u]], dtype=np.float32)
        m = t_rgb.dot(rot).dot(t_yiq)
        xf = x.astype('float32')
        out = nd.dot(xf.reshape(-1, 3), _const(m.T, x)).reshape(x.shape)
        return out.clip(0, 255)


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._transforms = []
        if brightness:
            self._transforms.append(RandomBrightness(brightness))
        if contrast:
            self._transforms.append(RandomContrast(contrast))
        if saturation:
            self._transforms.append(RandomSaturation(saturation))
        if hue:
            self._transforms.append(RandomHue(hue))

    def forward(self, x):
        order = np.random.permutation(len(self._transforms))
        for i in order:
            x = self._transforms[i](x)
        return x


class RandomLighting(Block):
    """AlexNet-style PCA noise (reference: image_aug_default.cc)."""

    _eigval = np.array([55.46, 4.794, 1.148], dtype=np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], dtype=np.float32)

    def __init__(self, alpha_std=0.05):
        super().__init__()
        self._alpha_std = alpha_std

    def forward(self, x):
        alpha = np.random.normal(0, self._alpha_std, 3).astype(np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return (x.astype('float32') + _const(rgb, x)).clip(0, 255)


class RandomGray(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if np.random.rand() < self._p:
            gray = (x.astype('float32') * _const(_GRAY, x)).sum(
                axis=2, keepdims=True)
            return nd.concat(gray, gray, gray, dim=2)
        return x.astype('float32')
