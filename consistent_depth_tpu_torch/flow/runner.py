"""Native flow runner: the port of ``consistent_depth_tpu/flow/runner.py``
(reference: optical_flow_flownet2_homography.py).

For each frame pair: optionally register frame2 onto frame1 with a feature
homography (RANSAC), run FlowNet2 on the (aligned) pair at a 64-multiple
resolution on the backend's device, compose the homography back into the
flow, and resize to the requested resolution. OpenCV is imported only in
the homography, resize and file branches, so frames already at a
64-multiple with ``homography=False`` run without it.

Run as ``python -m consistent_depth_tpu_torch.flow.runner --im1 ... --im2
... --out ... [--device cpu]``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..io import image_io
from ..models.layers import init_parameters
from ..models.torch_import import (checkpoint_for_module, flax_path,
                                   load_checkpoint, state_dict_for_module)
from .backends import (FlowBackend, align_homography,
                       compose_homography_flow, resize_flow)
from .flownet import FlowNet2, FlowNet2CSS

# the modules that only the full network has
_SD_FUSION = ("flownets_d", "flownetfusion")


def _round64(v: int) -> int:
    return max(64, int(round(v / 64)) * 64)


def _read_rgb(path: str) -> np.ndarray:
    """An image file as RGB float32 in [0, 1]."""
    import cv2

    return cv2.imread(path)[..., ::-1].astype(np.float32) / 255.0


class TorchFlowBackend(FlowBackend):
    """Runs FlowNet2 on ``device``: the full network (C->S->S + SD +
    fusion, like the reference's released checkpoint) when ``full``, else
    the C->S->S cascade. ``full=None`` picks the full network exactly when
    the checkpoint carries SD/fusion weights; a checkpoint's keys for
    branches the network lacks are ignored.

    Weights come from ``variables`` (the JAX package's tree, numpy
    leaves), else from ``checkpoint`` (a ``.pth`` in either key spelling),
    else from a seeded initialisation. Unlike the JAX backend, which
    prints a message and falls back to a random init, a checkpoint path
    that does not exist raises: the port never runs on weights it was not
    given. Computation is float32 with TF32 off."""

    name = "torch-flownet"

    def __init__(self, variables=None, checkpoint: Optional[str] = None,
                 homography: bool = True, seed: int = 0,
                 full: Optional[bool] = None, device="cuda"):
        self.homography = homography
        self.device = torch.device(device)
        sd = None
        if variables is None and checkpoint:
            if not os.path.isfile(checkpoint):
                raise FileNotFoundError(
                    f"flow checkpoint '{checkpoint}' not found (the port "
                    "never downloads weights; pass checkpoint=None for a "
                    "seeded initialisation)")
            sd = load_checkpoint(checkpoint)
        if full is None:
            full = sd is not None and any(
                flax_path(k)[0] in _SD_FUSION for k in sd)
        # built on the meta device so that construction draws nothing from
        # the global RNG; every parameter is then loaded (strict) or
        # initialised from the seed below
        with torch.device("meta"):
            net = FlowNet2() if full else FlowNet2CSS()
        net = net.to_empty(device="cpu")
        if variables is not None:
            weights = {k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in state_dict_for_module(variables,
                                                         net).items()}
            net.load_state_dict(weights, strict=True)
        elif sd is not None:
            net.load_state_dict(checkpoint_for_module(sd, net), strict=True)
        else:
            init_parameters(net, torch.Generator().manual_seed(seed))
        if self.device.type == "cuda":
            # f32 means f32: no TF32 in cuDNN convs or matmuls
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.net = net.eval().to(self.device,
                                 memory_format=torch.channels_last)

    def flow(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        """Images (B, H, W, 3) RGB in [0, 1] on the device, H and W
        multiples of 64 -> flow (B, H, W, 2) in pixels, on the device."""
        with torch.inference_mode():
            return self.net(im1, im2)

    def _to_device(self, im: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(im[None], np.float32))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def compute_pair(self, im1: np.ndarray, im2: np.ndarray) -> np.ndarray:
        """RGB images (H, W, 3) in [0, 1] -> flow (H, W, 2) in pixels at
        the input resolution (the network runs at the resolution rounded
        to 64, and its flow is resized back when the two differ)."""
        H, W = im1.shape[:2]
        Hn, Wn = _round64(H), _round64(W)

        homo = None
        im2_in = im2
        if self.homography:
            homo, im2_in = align_homography(im1, im2)

        def prep(im):
            if im.shape[:2] != (Hn, Wn):
                import cv2

                im = cv2.resize(im, (Wn, Hn), interpolation=cv2.INTER_LINEAR)
            return self._to_device(im)

        flow = self.flow(prep(im1), prep(im2_in))[0].cpu().numpy()
        if (Hn, Wn) != (H, W):
            flow = resize_flow(flow, (W, H))
        if homo is not None:
            flow = compose_homography_flow(flow, homo)
        return flow

    def process_pairs(self, frame_dir: str,
                      pairs: Sequence[Tuple[int, int]],
                      out_fmt: str, out_size: Tuple[int, int]) -> None:
        """Flow for each (i, j) of ``pairs`` between
        ``frame_dir/frame_{i:06d}.png`` and ``..._{j:06d}.png``, resized to
        ``out_size`` (W, H) and saved as ``out_fmt.format(i, j)``. Existing
        outputs are skipped."""
        for (i, j) in pairs:
            out_fn = out_fmt.format(i, j)
            if os.path.isfile(out_fn):
                continue
            im1 = _read_rgb(os.path.join(frame_dir, f"frame_{i:06d}.png"))
            im2 = _read_rgb(os.path.join(frame_dir, f"frame_{j:06d}.png"))
            image_io.save_raw_float32_image(
                out_fn, resize_flow(self.compute_pair(im1, im2), out_size))


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Standalone flow CLI (reference:
    optical_flow_flownet2_homography.py:108-271): compute flow from each
    --im1[i] to --im2[i], save .raw (and optionally a colour-wheel PNG) at
    --out[i]. Existing outputs are skipped, like every other stage."""
    import argparse

    parser = argparse.ArgumentParser(
        "Compute optical flow from im1 to im2")
    parser.add_argument("--im1", nargs="+", required=True)
    parser.add_argument("--im2", nargs="+", required=True)
    parser.add_argument("--out", nargs="+", required=True)
    parser.add_argument("--checkpoint", type=str, default="",
                        help="FlowNet2 .pth/.pth.tar state dict; a seeded "
                        "init when empty (useful only for smoke runs); a "
                        "path that does not exist raises")
    parser.add_argument("--homography", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="pre-align im2 onto im1 with a RANSAC "
                        "feature homography before the network")
    parser.add_argument("--size", type=int, nargs=2, default=None,
                        metavar=("H", "W"),
                        help="resize the output flow to (H, W)")
    parser.add_argument("--visualize", action="store_true",
                        help="also write a colour-wheel PNG next to "
                        "each .raw output")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the network runs on")
    args = parser.parse_args(argv)
    if not (len(args.im1) == len(args.im2) == len(args.out)):
        parser.error("--im1/--im2/--out must have equal lengths")

    backend = TorchFlowBackend(
        checkpoint=args.checkpoint, homography=args.homography,
        device=args.device)
    for im1_fn, im2_fn, out_fn in zip(args.im1, args.im2, args.out):
        if os.path.isfile(out_fn):
            continue
        flow = backend.compute_pair(_read_rgb(im1_fn), _read_rgb(im2_fn))
        if args.size is not None:
            flow = resize_flow(flow, (args.size[1], args.size[0]))
        d = os.path.dirname(out_fn)
        if d:
            os.makedirs(d, exist_ok=True)
        image_io.save_raw_float32_image(out_fn, flow)
        if args.visualize:
            import cv2

            from ..ops.flow_viz import flow_to_image

            cv2.imwrite(os.path.splitext(out_fn)[0] + ".png",
                        flow_to_image(flow)[..., ::-1])


if __name__ == "__main__":
    main()
