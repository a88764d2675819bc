"""Seeded camera-like content for the benchmark's traffic mixes.

One general generator reads a traffic file (hevc_bench/traffic/<mix>.json)
and makes 8-bit 4:2:0 frames from `--seed`:

  * a periodic multi-scale texture (octaves of bilinearly upsampled
    uniform noise, coarse to fine, amplitudes from the file) as the
    background, panned by a whole number of pixels a frame;
  * rectangular textured objects of fixed sizes and velocities, wrapping
    at the picture's edges;
  * Gaussian sensor noise of a fixed sigma on every plane;
  * with `scene_cut_every` N > 0, a new scene (new textures and object
    positions) every N frames.

The seed draws only textures, object positions and noise: sizes, speeds
and cut positions come from the file, so every seed gives the encoder
the same kind of work in the same order. Frames are made on the device
the generator is given, one at a time, and returned as numpy planes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MASK63 = (1 << 63) - 1


def derive_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for one use of the run's seed (scene, noise of frame
    i), by a fixed integer mix: the same inputs give the same seed."""
    x = seed & _MASK63
    for p in parts:
        x = (x * 6364136223846793005 + p * 1442695040888963407
             + 0x9E3779B97F4A7C15) & _MASK63
        x ^= x >> 29
    return x


def _periodic_texture(gen, shape, cells, amps, device) -> torch.Tensor:
    """[H, W] float32 periodic texture: for each (cell, amplitude), a grid
    of uniform noise in [-1, 1] of one value per cell x cell pixels,
    upsampled bilinearly with wrap-around, times the amplitude; summed."""
    H, W = shape
    out = torch.zeros((H, W), dtype=torch.float32, device=device)
    for c, a in zip(cells, amps):
        gh, gw = max(H // c, 1), max(W // c, 1)
        g = torch.rand((1, 1, gh, gw), generator=gen, device=device) * 2 - 1
        g = F.pad(g, (1, 1, 1, 1), mode="circular")
        up = F.interpolate(g, size=((gh + 2) * H // gh, (gw + 2) * W // gw),
                           mode="bilinear", align_corners=False)
        ch, cw = H // gh, W // gw
        out += a * up[0, 0, ch:ch + H, cw:cw + W]
    return out


class Scene:
    """One scene's canvases (Y, U, V at full resolution), its objects'
    patches and start positions, all drawn from one seed."""

    def __init__(self, mix: dict, width: int, height: int, seed: int,
                 device):
        tex = mix["texture"]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        ch, cw = tex["canvas_px"]
        cells, amps = tex["cells_px"], tex["amplitudes"]
        csc, cmin = tex["chroma_amplitude_scale"], tex["chroma_min_cell_px"]
        camps = [a * csc for c, a in zip(cells, amps) if c >= cmin]
        ccells = [c for c in cells if c >= cmin]
        self.canvas = [
            128 + _periodic_texture(gen, (ch, cw), cells, amps, device),
            128 + _periodic_texture(gen, (ch, cw), ccells, camps, device),
            128 + _periodic_texture(gen, (ch, cw), ccells, camps, device)]
        self.objects = []
        for ob in mix["objects"]:
            oh = min(ob["size_px"][1], height)
            ow = min(ob["size_px"][0], width)
            pos = torch.randint(0, 1 << 30, (4,), generator=gen,
                                device=device).tolist()
            shift = (torch.rand((3,), generator=gen, device=device) * 2 - 1) \
                * torch.tensor(tex["object_offset"], device=device)
            oy, ox = pos[0] % (ch - oh), pos[1] % (cw - ow)
            patch = [128 + _periodic_texture(gen, (oh, ow), cells, amps,
                                             device) + shift[0]]
            patch += [self.canvas[k][oy:oy + oh, ox:ox + ow] + shift[k]
                      for k in (1, 2)]
            self.objects.append((patch, pos[2] % height, pos[3] % width,
                                 ob["velocity_px_per_frame"]))


class Content:
    """Frame i of a traffic mix at width x height from a seed:
    `frame(i)` -> (y, u, v) uint8 numpy planes (4:2:0)."""

    def __init__(self, mix: dict, width: int, height: int, seed: int,
                 device="cpu"):
        if width % 2 or height % 2:
            raise ValueError("4:2:0 content needs an even width and height")
        self.mix, self.w, self.h = mix, width, height
        self.seed, self.device = seed, torch.device(device)
        self.every = int(mix.get("scene_cut_every", 0))
        self._scene_idx, self._scene = None, None

    def scene_of(self, i: int):
        """(scene index, frame index within the scene) of frame i."""
        return (i // self.every, i % self.every) if self.every else (0, i)

    def _scene_for(self, s: int) -> Scene:
        if s != self._scene_idx:
            self._scene = Scene(self.mix, self.w, self.h,
                                derive_seed(self.seed, 1, s), self.device)
            self._scene_idx = s
        return self._scene

    def frame(self, i: int):
        s, t = self.scene_of(i)
        sc = self._scene_for(s)
        H, W = self.h, self.w
        dev = self.device
        px, py = self.mix["pan_px_per_frame"]
        ch, cw = sc.canvas[0].shape
        rows = (torch.arange(H, device=dev) + py * t) % ch
        cols = (torch.arange(W, device=dev) + px * t) % cw
        planes = [c.index_select(0, rows).index_select(1, cols).clone()
                  for c in sc.canvas]
        for patch, y0, x0, (vx, vy) in sc.objects:
            oh, ow = patch[0].shape
            r = (torch.arange(oh, device=dev) + y0 + vy * t) % H
            c = (torch.arange(ow, device=dev) + x0 + vx * t) % W
            for k in range(3):
                planes[k][r[:, None], c[None, :]] = patch[k]
        gen = torch.Generator(device=dev)
        gen.manual_seed(derive_seed(self.seed, 2, i))
        sigma = float(self.mix["noise_sigma"])
        y = planes[0] + sigma * torch.randn((H, W), generator=gen, device=dev)
        uv = F.avg_pool2d(torch.stack(planes[1:])[:, None], 2)[:, 0]
        uv = uv + sigma * torch.randn(uv.shape, generator=gen, device=dev)
        flat = torch.cat((y.reshape(-1), uv.reshape(-1))).round_() \
            .clamp_(0, 255).to(torch.uint8).cpu().numpy()
        n, m = H * W, (H // 2) * (W // 2)
        return (flat[:n].reshape(H, W), flat[n:n + m].reshape(H // 2, W // 2),
                flat[n + m:].reshape(H // 2, W // 2))
