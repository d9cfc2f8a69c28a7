"""Train-time image augmentation on the device (the port of the JAX
package's ``data/augment.py``).

Per sample, each op fires with probability ``prob``: Rotate (limit 90
degrees, with the largest inscribed rectangle cropped and resized back —
albumentations' crop_border=True), zoom (ShiftScaleRotate scale +-0.5),
Perspective (scale 0.05..0.1, keep_size), vertical and horizontal flips —
all composed into ONE homography per sample and applied as one bilinear
inverse warp with a zero border — then Gaussian blur (sigma 0.8..1.4 on a
7x7 kernel), brightness / contrast (+-0.2) and sharpen (alpha 0.2..0.5,
lightness 0.5..1.0), the two convolutions with edge padding.

uint8 NHWC in, uint8 out. The draws come from one explicit
``torch.Generator`` per batch (17 uniforms and 8 normals per sample), so
the bits differ from the JAX package's; the deterministic pieces (the
matrices, the warp, the kernels) are the JAX formulas and are tested
against them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _eye(b, device):
    return torch.eye(3, device=device).expand(b, 3, 3).clone()


def inscribed_rect(theta: torch.Tensor, h: int, w: int):
    """Largest axis-aligned rectangle inside an h x w image rotated by
    ``theta`` [B] (albumentations' _rotated_rect_with_max_area), clamped to
    the canvas. Returns (hr, wr), each [B]."""
    sa = theta.sin().abs()
    ca = theta.cos().abs()
    side_long, side_short = float(max(w, h)), float(min(w, h))
    half = (side_short <= 2.0 * sa * ca * side_long) | ((sa - ca).abs()
                                                        < 1e-10)
    x = 0.5 * side_short
    sa_s = sa.clamp_min(1e-6)
    ca_s = ca.clamp_min(1e-6)
    if w >= h:
        wr_h, hr_h = x / sa_s, x / ca_s
    else:
        wr_h, hr_h = x / ca_s, x / sa_s
    cos2a = ca * ca - sa * sa
    cos2a = torch.where(cos2a.abs() < 1e-10, torch.full_like(cos2a, 1e-10),
                        cos2a)
    wr_g = (w * ca - h * sa) / cos2a
    hr_g = (h * ca - w * sa) / cos2a
    hr = torch.where(half, hr_h, hr_g)
    wr = torch.where(half, wr_h, wr_g)
    return hr.clamp_max(float(h)), wr.clamp_max(float(w))


def rotate_crop_matrix(theta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, 3, 3] inverse-warp matrices (centered (y, x) coords): rotate by
    ``theta``, crop the inscribed rectangle, resize back to h x w."""
    c, s = theta.cos(), theta.sin()
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, -s, z], -1),
                       torch.stack([s, c, z], -1),
                       torch.stack([z, z, o], -1)], -2)
    hr, wr = inscribed_rect(theta, h, w)
    crop = torch.diag_embed(torch.stack([hr / h, wr / w, o], -1))
    return rot @ crop


def solve_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """[B, 3, 3] homographies mapping 4 (x, y) points ``src`` [B, 4, 2] to
    ``dst`` (cv2.getPerspectiveTransform's 8x8 system), H[2, 2] = 1."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    rows_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    rows_v = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    a = torch.cat([rows_u, rows_v], -2)                      # [B, 8, 8]
    rhs = torch.cat([u, v], -1)                               # [B, 8]
    hvec = torch.linalg.solve(a, rhs)
    return torch.cat([hvec, torch.ones_like(hvec[:, :1])],
                     -1).reshape(-1, 3, 3)


def perspective_corners(scale: torch.Tensor, normals: torch.Tensor,
                        h: int, w: int):
    """A.Perspective's corner sampling from its draws: ``scale`` [B] in
    (0.05, 0.1) and ``normals`` [B, 4, 2] standard normal. Returns (pts
    [B, 4, 2] absolute (x, y), tl/tr/br/bl; max_width [B]; max_height
    [B])."""
    jit = torch.remainder((normals * scale[:, None, None]).abs(), 0.32)
    base = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]],
                        device=scale.device)
    sign = torch.tensor([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]],
                        device=scale.device)
    pts = (base + sign * jit) * torch.tensor([float(w), float(h)],
                                             device=scale.device)
    tl, tr, br, bl = pts.unbind(1)
    mw = torch.floor(torch.maximum((tr - tl).norm(dim=-1),
                                   (br - bl).norm(dim=-1)))
    mh = torch.floor(torch.maximum((tr - br).norm(dim=-1),
                                   (tl - bl).norm(dim=-1)))
    return pts, mw, mh


def perspective_matrix(pts: torch.Tensor, mw: torch.Tensor,
                       mh: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, 3, 3] inverse-warp matrices (absolute (y, x) coords) of
    A.Perspective with its sampled corners: the rectangle [0, mw-1] x
    [0, mh-1] onto the quad, then the keep_size resize back to w x h."""
    dst = torch.stack([torch.tensor([0.0, 1.0, 1.0, 0.0],
                                    device=pts.device) * (mw[:, None] - 1.0),
                       torch.tensor([0.0, 0.0, 1.0, 1.0],
                                    device=pts.device) * (mh[:, None] - 1.0)],
                      -1)
    p_inv = solve_homography(dst, pts)
    sx, sy = mw / float(w), mh / float(h)
    resize = _eye(pts.shape[0], pts.device)
    resize[:, 0, 0] = sx
    resize[:, 0, 2] = 0.5 * sx - 0.5
    resize[:, 1, 1] = sy
    resize[:, 1, 2] = 0.5 * sy - 0.5
    swap = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                        device=pts.device)
    return swap @ (p_inv @ resize) @ swap


def homography(u: torch.Tensor, normals: torch.Tensor, h: int, w: int,
               p: float) -> torch.Tensor:
    """Rotate / zoom / perspective / flips composed into [B, 3, 3] maps
    from OUTPUT pixel coords to SOURCE coords. ``u`` [B, >= 17] uniforms:
    0 angle, 1 rotate fires, 2 zoom, 3 zoom fires, 4 perspective scale,
    5 perspective fires, 6 vflip, 7 hflip."""
    b, dev = u.shape[0], u.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    eye = _eye(b, dev)

    def maybe(col, mat):
        return torch.where((u[:, col] < p)[:, None, None], mat, eye)

    theta = (u[:, 0] * 2.0 - 1.0) * (math.pi / 2)
    rot = maybe(1, rotate_crop_matrix(theta, h, w))
    scale = 1.0 + (u[:, 2] - 0.5)
    one = torch.ones_like(scale)
    zoom = maybe(3, torch.diag_embed(torch.stack([1.0 / scale, 1.0 / scale,
                                                  one], -1)))
    vf = torch.where(u[:, 6] < p, -one, one)
    hf = torch.where(u[:, 7] < p, -one, one)
    flip = torch.diag_embed(torch.stack([vf, hf, one], -1))
    center = torch.tensor([[1.0, 0.0, cy], [0.0, 1.0, cx], [0.0, 0.0, 1.0]],
                          device=dev)
    uncenter = torch.tensor([[1.0, 0.0, -cy], [0.0, 1.0, -cx],
                             [0.0, 0.0, 1.0]], device=dev)
    pts, mw, mh = perspective_corners(0.05 + 0.05 * u[:, 4], normals, h, w)
    persp = maybe(5, uncenter @ perspective_matrix(pts, mw, mh, h, w)
                  @ center)
    return center @ persp @ rot @ zoom @ flip @ uncenter


def warp_bilinear(img: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Inverse-warp fp32 [B, H, W, C] images by [B, 3, 3] (y, x) matrices,
    bilinear, each tap outside the source read as zero."""
    b, h, w, _ = img.shape
    dev = img.device
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([gy, gx, torch.ones_like(gy)]).reshape(3, h * w)
    src = mat @ grid                                          # [B, 3, HW]
    sy, sx = src[:, 0] / src[:, 2], src[:, 1] / src[:, 2]
    # grid_sample's normalised (x, y): with align_corners=True, -1 and 1 are
    # the centres of the first and last pixels
    norm = torch.stack([sx * (2.0 / max(w - 1, 1)) - 1.0,
                        sy * (2.0 / max(h - 1, 1)) - 1.0], -1)
    out = F.grid_sample(img.permute(0, 3, 1, 2), norm.reshape(b, h, w, 2),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


def dwconv(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Per-sample depthwise KxK correlation with EDGE padding: fp32
    [B, H, W, C] images, [B, K, K] kernels."""
    b, h, w, c = img.shape
    r = kernel.shape[-1] // 2
    x = F.pad(img.permute(0, 3, 1, 2), (r, r, r, r), mode="replicate")
    weight = kernel[:, None].repeat_interleave(c, dim=0)      # [B*C, 1, K, K]
    y = F.conv2d(x.reshape(1, b * c, h + 2 * r, w + 2 * r), weight,
                 groups=b * c)
    return y.reshape(b, c, h, w).permute(0, 2, 3, 1)


def gauss_kernel7(sigma: torch.Tensor) -> torch.Tensor:
    """[B, 7, 7] normalized Gaussians of ``sigma`` [B]."""
    d = torch.arange(-3.0, 4.0, device=sigma.device)
    g = torch.exp(-(d ** 2) / (2.0 * sigma[:, None] ** 2))
    k = g[:, :, None] * g[:, None, :]
    return k / k.sum(dim=(1, 2), keepdim=True)


def augment_batch(images_u8: torch.Tensor, prob: float,
                  generator: torch.Generator) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> augmented uint8, each sample with its own
    draws from `generator` (on the images' device)."""
    b, h, w, _ = images_u8.shape
    dev = images_u8.device
    u = torch.rand((b, 17), generator=generator, device=dev)
    normals = torch.randn((b, 4, 2), generator=generator, device=dev)
    x = warp_bilinear(images_u8.float(), homography(u, normals, h, w, prob))

    def fires(col):
        return (u[:, col] < prob)[:, None, None, None]

    blur = dwconv(x, gauss_kernel7(0.8 + 0.6 * u[:, 16]))
    x = torch.where(fires(8), blur, x)
    alpha = (1.0 + (u[:, 9] * 0.4 - 0.2))[:, None, None, None]
    beta = ((u[:, 10] * 0.4 - 0.2) * 255.0)[:, None, None, None]
    x = torch.where(fires(11), x * alpha + beta, x)
    s_alpha = (0.2 + 0.3 * u[:, 12])[:, None, None, None]
    light = 0.5 + 0.5 * u[:, 13]
    ident = torch.zeros((3, 3), device=dev)
    ident[1, 1] = 1.0
    laplace = torch.tensor([[-1.0, -1.0, -1.0], [-1.0, 8.0, -1.0],
                            [-1.0, -1.0, -1.0]], device=dev) / 8.0
    sharp = dwconv(x, ident + laplace * light[:, None, None])
    x = torch.where(fires(14), (1 - s_alpha) * x + s_alpha * sharp, x)
    return x.clamp(0.0, 255.0).to(torch.uint8)
