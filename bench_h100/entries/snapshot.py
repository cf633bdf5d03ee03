"""Entry `snapshot`: the viewer's frame, `camera.snapshot` of the program
on the configuration's detector (the program's own flat Geometry and its
device arrays), one frame a call, and its judgement against the
reference renderer.

A call asks for one frame at a camera position drawn from the seed and
returns when the (height, width, 3) image is on the host. snapshot does
what the interactive viewer does for each frame (camera.Camera._frame):
the pose's rays built on the host (tools.from_film) and uploaded, the
depth-peeled render (K1 on the card), the pixels unpacked on the host;
and besides, the default pose from the geometry's bounds. Every frame of
the window keeps its position and a seeded sample of its pixels.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from bench_h100.harness import traffic
from bench_h100.reference import render as ref_render

JUDGE_SITE = 0x7E4D
POSE_SITE = 0xCA
JUDGED_FRAMES = 4
PIXELS = 1 << 14        # sampled pixels a frame
WARM_INDEX = 1 << 40
TOLERANCE = 1           # counts a channel may differ by


class Entry:
    SPANS = [('chroma_tpu_torch.camera', '_scene_pose', 'bench.pose'),
             ('chroma_tpu_torch.camera', 'CameraPose.rays', 'bench.rays'),
             ('chroma_tpu_torch.camera', 'from_film', 'bench.from_film'),
             ('chroma_tpu_torch.camera', 'render', 'bench.render'),
             ('chroma_tpu_torch.camera', '_pixels_to_image', 'bench.packing'),
             ('chroma_tpu_torch.camera', 'pixels_to_host',
              'bench.pixels_to_host')]

    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.mix
        self.size = (int(ctx.mix['width']), int(ctx.mix['height']))
        self.n = self.size[0] * self.size[1]
        self.pixels = traffic.sample(self.n, PIXELS, ctx.seed, JUDGE_SITE)
        self.kept = {}

    def setup(self):
        ctx = self.ctx
        arrays, _ = ctx.config_module.port_geometry(ctx.cfg, ctx.cache_dir,
                                                    dense=True)
        self.arrays = arrays.to(ctx.device)
        self.geometry = ctx.config_module.port_detector(ctx.cfg,
                                                        ctx.cache_dir)

    def warm_indices(self):
        return [WARM_INDEX, WARM_INDEX + 1]

    def position(self, index):
        "The camera of frame `index`: on its orbit at a seeded angle."
        gen = traffic.generator('cpu', self.ctx.seed, POSE_SITE, index)
        phi = 2 * math.pi * float(torch.rand((), generator=gen,
                                             dtype=torch.float64))
        r = float(self.ctx.cfg['scene_radius_mm'])
        rho = float(self.mix['orbit_over_radius']) * r
        dist = float(self.mix['camera_distance_over_radius']) * r
        return np.array([rho * math.cos(phi), -dist, rho * math.sin(phi)])

    def call(self, index, window):
        from chroma_tpu_torch import camera
        pos = self.position(index)
        t0 = time.perf_counter()
        img = camera.snapshot(self.geometry, size=self.size, position=pos,
                              alpha_depth=int(self.mix['alpha_depth']),
                              bg_color=int(self.mix['bg_color']),
                              geometry_arrays=self.arrays,
                              device=self.ctx.device)
        latency = time.perf_counter() - t0
        if window:
            px = self.pixels.numpy()
            h = self.size[1]
            self.kept[index] = (pos, torch.as_tensor(
                img[px % h, px // h].astype(np.int64)))
        return dict(index=index, latency_s=latency, frames=1,
                    pixels=self.n)

    def release(self):
        self.arrays = self.geometry = None

    def reference_scene(self):
        "The reference's scene (its optics, at any wavelength, unused)."
        ctx = self.ctx
        return ctx.config_module.reference_scene(ctx.cfg, 400.0).to(
            ctx.device)

    def judge(self, scene):
        """The share (%) of sampled pixels whose colour differs from the
        reference's by more than TOLERANCE counts in a channel."""
        ctx = self.ctx
        frames = sorted(self.kept)
        pick = traffic.sample(len(frames), JUDGED_FRAMES, ctx.seed,
                              JUDGE_SITE + 1).tolist()
        bad, total, queries = 0, 0, []
        for i in pick:
            pos, prog = self.kept[frames[i]]
            o, d = ref_render.film_rays(pos, self.size,
                                        pixels=self.pixels.numpy())
            pix, q = ref_render.render(scene, o, d,
                                       int(self.mix['alpha_depth']),
                                       int(self.mix['bg_color']))
            ref = torch.stack([(pix >> s) & 0xFF for s in (16, 8, 0)],
                              1).cpu()
            bad += int(((ref - prog).abs() > TOLERANCE).any(1).sum())
            total += len(prog)
            queries.append(q.double().mean().item())
        numbers = dict(pixel_mismatch_pct=100.0 * bad / max(total, 1))
        facts = dict(queries_per_pixel=float(np.mean(queries)),
                     judged_frames=[frames[i] for i in pick])
        return numbers, facts
