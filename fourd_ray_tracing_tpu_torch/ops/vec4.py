"""Structure-of-arrays 4D/3D vector types over torch tensors.

Counterpart of fourd_ray_tracing_tpu/ops/vec4.py: each component is its
own tensor of any shape (0-d for scene and camera parameters, (H, W) or
(V, H, W) for pixel batches), so every vector op is a plain elementwise
torch op. The operation order of every helper is the JAX package's
(``dot`` sums x, y, z, w left to right; ``normalize`` multiplies by the
reciprocal length), which is what keeps the two renderers within float
rounding of each other.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from fourd_ray_tracing_tpu_torch.utils import profiling

Scalar = Union[torch.Tensor, float, int]


def f32(value, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``: on a card, a copy that waits for
    the device's stream (the span ``sync.scalar``)."""
    with profiling.sync("scalar", device):
        return torch.tensor(value, dtype=torch.float32, device=device)


class Vec3(NamedTuple):
    """SoA 3-vector (light / color)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def full(value: float, like: torch.Tensor) -> "Vec3":
        v = torch.full_like(like, value)
        return Vec3(v, v, v)

    @staticmethod
    def of(x: float, y: float, z: float, device) -> "Vec3":
        return Vec3(f32(x, device), f32(y, device), f32(z, device))

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __mul__(self, o: Union["Vec3", Scalar]) -> "Vec3":
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def where(self, mask: torch.Tensor, other: "Vec3") -> "Vec3":
        """Elementwise select: mask ? self : other."""
        return Vec3(
            torch.where(mask, self.x, other.x),
            torch.where(mask, self.y, other.y),
            torch.where(mask, self.z, other.z),
        )

    def stack(self, dim: int = -1) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=dim)


class Vec4(NamedTuple):
    """SoA 4-vector (positions / directions in R^4)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor

    @staticmethod
    def of(x: float, y: float, z: float, w: float, device) -> "Vec4":
        return Vec4(*(f32(c, device) for c in (x, y, z, w)))

    def __add__(self, o: "Vec4") -> "Vec4":
        return Vec4(self.x + o.x, self.y + o.y, self.z + o.z, self.w + o.w)

    def __sub__(self, o: "Vec4") -> "Vec4":
        return Vec4(self.x - o.x, self.y - o.y, self.z - o.z, self.w - o.w)

    def __mul__(self, s: Scalar) -> "Vec4":
        return Vec4(self.x * s, self.y * s, self.z * s, self.w * s)

    def __neg__(self) -> "Vec4":
        return Vec4(-self.x, -self.y, -self.z, -self.w)

    __rmul__ = __mul__

    def where(self, mask: torch.Tensor, other: "Vec4") -> "Vec4":
        """Elementwise select: mask ? self : other."""
        return Vec4(
            torch.where(mask, self.x, other.x),
            torch.where(mask, self.y, other.y),
            torch.where(mask, self.z, other.z),
            torch.where(mask, self.w, other.w),
        )


def dot(a: Vec4, b: Vec4) -> torch.Tensor:
    """4D dot product, summed x, y, z, w left to right."""
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of the kernels' sqrtf. torch.sqrt
    is one on CUDA; on the CPU its vectorized float32 kernel is not (about
    0.5% of values come out an ulp off), so a float32 tensor there goes
    through float64, whose square root rounded to float32 is correctly
    rounded (53 >= 2 * 24 + 2 bits)."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def length(a: Vec4) -> torch.Tensor:
    return sqrt(dot(a, a))


def normalize(a: Vec4) -> Vec4:
    return a * (1.0 / length(a))


def reflect(d: Vec4, n: Vec4) -> Vec4:
    """GLSL reflect(): d - 2*dot(d,n)*n."""
    return d - n * (2.0 * dot(d, n))


def redirect(v: Vec4, n: Vec4) -> Vec4:
    """Flip v into the hemisphere of n if it points inward."""
    d = dot(v, n)
    flipped = v - n * (2.0 * d)
    return v.where(d >= 0.0, flipped)


def vec_in_space(v: Vec4, norm: Vec4) -> Vec4:
    """v without its component along norm."""
    return v - norm * dot(v, norm)


def vec_to_space(point: Vec4, space_point: Vec4, space_norm: Vec4) -> Vec4:
    """The vector from point to the hyperplane {space_point, space_norm}."""
    return space_norm * dot(space_point - point, space_norm)


def point_in_space(point: Vec4, space_point: Vec4, space_norm: Vec4) -> Vec4:
    """point projected onto the hyperplane {space_point, space_norm}."""
    return point + vec_to_space(point, space_point, space_norm)
