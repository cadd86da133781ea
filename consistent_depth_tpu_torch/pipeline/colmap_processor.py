"""COLMAP SfM/MVS subprocess driver: the port's copy of
``consistent_depth_tpu/pipeline/colmap_processor.py`` (reference:
tools/colmap_processor.py).

COLMAP remains an external C++ binary; this module drives it when present
and validates cached outputs when not. Also usable as a standalone CLI:
``python -m consistent_depth_tpu_torch.pipeline.colmap_processor``.
"""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys
from os.path import join as pjoin

import numpy as np


class COLMAPParams:
    def __init__(self):
        self.parser = argparse.ArgumentParser()
        self.parser.add_argument("image_path", help="image path")
        self.parser.add_argument("workspace_path", help="workspace path")
        self.parser.add_argument(
            "--mask_path", default=None,
            help="mask path to exclude features from those regions")
        self.parser.add_argument(
            "--dense_max_size", type=int, default=384,
            help="max size for dense COLMAP")
        self.add_arguments(self.parser)

    @staticmethod
    def add_arguments(parser):
        parser.add_argument("--colmap_bin_path", default="colmap",
                            help="path to the colmap binary (3.6+)")
        parser.add_argument("--sparse", action="store_true",
                            help="disable dense reconstruction")
        parser.add_argument("--initialize_pose", action="store_true")
        parser.add_argument("--camera_params", default=None)
        parser.add_argument("--camera_model", default="SIMPLE_PINHOLE")
        parser.add_argument("--refine_intrinsics", action="store_true")
        parser.add_argument("--matcher", default="exhaustive",
                            choices=["exhaustive", "sequential"])
        parser.add_argument(
            "--colmap_keep_going", action="store_true",
            help="log and continue past failed COLMAP subcommands "
                 "(reference tools/colmap_processor.py:248-250 behavior) "
                 "instead of raising at the failing step")

    def parse_args(self, args=None, namespace=None):
        return self.parser.parse_args(args, namespace=namespace)


class COLMAPProcessor:
    def __init__(self, colmap_bin: str = "colmap", fail_fast: bool = True):
        self.colmap_bin = colmap_bin
        # fail_fast=False restores the reference's log-and-continue on a
        # nonzero subcommand rc (tools/colmap_processor.py:248-250);
        # the default raises at the failing subcommand instead of
        # surfacing later as a confusing missing-sparse-model crash.
        self.fail_fast = fail_fast
        self._workspace = None

    def _run(self, cmd):
        run(cmd, fail_fast=self.fail_fast, workspace=self._workspace)

    def process(self, args):
        self._workspace = args.workspace_path
        os.makedirs(args.workspace_path, exist_ok=True)
        self.extract_features(args)
        self.match(args)
        if args.initialize_pose:
            self.triangulate(args)
        else:
            self.map(args)

        models = os.listdir(self.sparse_dir(args.workspace_path))
        logging.info("#models = %d", len(models))
        if len(models) > 1:
            logging.error(
                "COLMAP reconstructs more than one model (#models=%d)",
                len(models))
        if "sparse" not in vars(args) or not args.sparse:
            for sub_model in models:
                self.dense(sub_model, args)

    def extract_features(self, args):
        cmd = [
            self.colmap_bin, "feature_extractor",
            "--database_path", self.db_path(args.workspace_path),
            "--image_path", args.image_path,
            "--ImageReader.camera_model", args.camera_model,
            "--ImageReader.single_camera", "1",
        ]
        if args.camera_params:
            cmd += ["--ImageReader.camera_params", args.camera_params]
        if args.mask_path:
            cmd += ["--ImageReader.mask_path", args.mask_path]
        if args.initialize_pose:
            cmd += ["--SiftExtraction.num_threads", "1",
                    "--SiftExtraction.gpu_index", "0"]
        self._run(cmd)

    def match(self, args):
        cmd = [
            self.colmap_bin, f"{args.matcher}_matcher",
            "--database_path", self.db_path(args.workspace_path),
            "--SiftMatching.guided_matching", "1",
        ]
        if args.matcher == "sequential":
            cmd += ["--SequentialMatching.overlap", "50",
                    "--SequentialMatching.quadratic_overlap", "0"]
        self._run(cmd)

    def triangulate(self, args):
        if self.check_sparse(self.sparse_dir(args.workspace_path, 0)):
            return
        pose_init_dir = self.pose_init_dir(args.workspace_path)
        if not self.check_sparse(pose_init_dir):
            raise FileNotFoundError(
                f"--initialize_pose needs a sparse model in {pose_init_dir}")
        sparse_dir = self.sparse_dir(args.workspace_path, 0)
        os.makedirs(sparse_dir, exist_ok=True)
        self._run([
            self.colmap_bin, "point_triangulator",
            "--database_path", self.db_path(args.workspace_path),
            "--image_path", args.image_path,
            "--output_path", sparse_dir,
            "--input_path", pose_init_dir,
            "--Mapper.ba_refine_focal_length", "0",
            "--Mapper.ba_local_max_num_iterations", "0",
            "--Mapper.ba_global_max_num_iterations", "1",
        ])

    def map(self, args):
        if self.check_sparse(self.sparse_dir(args.workspace_path, 0)):
            return
        sparse_dir = self.sparse_dir(args.workspace_path)
        os.makedirs(sparse_dir, exist_ok=True)
        cmd = [
            self.colmap_bin, "mapper",
            "--database_path", self.db_path(args.workspace_path),
            "--image_path", args.image_path,
            "--output_path", sparse_dir,
            # KITTI-tuned BA flags (reference: tools/colmap_processor.py:158-163)
            "--Mapper.abs_pose_min_inlier_ratio", "0.5",
            "--Mapper.abs_pose_min_num_inliers", "50",
            "--Mapper.init_max_forward_motion", "1",
            "--Mapper.ba_local_num_images", "15",
        ]
        if args.camera_params and not args.refine_intrinsics:
            cmd += ["--Mapper.ba_refine_focal_length", "0",
                    "--Mapper.ba_refine_extra_params", "0"]
        self._run(cmd)

    def dense(self, recon_model, args):
        dense_dir = self.dense_dir(args.workspace_path, recon_model)
        if self.check_dense(dense_dir, args.image_path):
            return
        os.makedirs(dense_dir, exist_ok=True)
        self._run([
            self.colmap_bin, "image_undistorter",
            "--image_path", args.image_path,
            "--input_path", self.sparse_dir(args.workspace_path, recon_model),
            "--output_path", dense_dir,
            "--output_type", "COLMAP",
            "--max_image_size", str(args.dense_max_size),
        ])
        self._run([
            self.colmap_bin, "patch_match_stereo",
            "--workspace_path", dense_dir,
            "--workspace_format", "COLMAP",
            "--PatchMatchStereo.max_image_size", str(args.dense_max_size),
        ])

    @staticmethod
    def dense_depth_suffix() -> str:
        return ".geometric.bin"

    @staticmethod
    def db_path(workspace):
        return pjoin(workspace, "database.db")

    @staticmethod
    def sparse_dir(workspace, model_index=None):
        p = pjoin(workspace, "sparse")
        return p if model_index is None else pjoin(p, str(model_index))

    @staticmethod
    def dense_dir(workspace, model_index=None):
        p = pjoin(workspace, "dense")
        return p if model_index is None else pjoin(p, str(model_index))

    @staticmethod
    def pose_init_dir(workspace):
        return pjoin(workspace, "pose_init")

    @staticmethod
    def check_sparse(sparse_model_dir: str) -> bool:
        return any(
            all(os.path.isfile(pjoin(sparse_model_dir, name))
                for name in ("cameras" + ext, "images" + ext))
            for ext in (".bin", ".txt")
        )

    @classmethod
    def check_dense(cls, dense_model_dir: str, image_path: str,
                    valid_ratio: float = 1) -> bool:
        if valid_ratio > 1:
            raise ValueError(f"valid_ratio {valid_ratio} > 1")
        depth_fmt = pjoin(
            dense_model_dir, "stereo", "depth_maps",
            "{}" + cls.dense_depth_suffix())
        if not os.path.isdir(image_path):
            return False
        color_names = os.listdir(image_path)
        if not color_names:
            return False
        num_valid = np.sum(
            [os.path.isfile(depth_fmt.format(n)) for n in color_names])
        return (num_valid / len(color_names)) >= valid_ratio


def run(cmd, fail_fast: bool = True, workspace: str = None):
    print(" ".join(cmd))
    result = subprocess.run(cmd)
    if result.returncode != 0:
        where = f" (workspace: {workspace})" if workspace else ""
        msg = (f"COLMAP subcommand '{cmd[1]}' failed with rc="
               f"{result.returncode}{where}; command: {' '.join(cmd)}")
        if fail_fast:
            raise RuntimeError(
                msg + ". Pass --colmap_keep_going to log-and-continue "
                "(the reference's behavior).")
        logging.error(msg)


def main(args):
    COLMAPProcessor(
        args.colmap_bin_path,
        fail_fast=not getattr(args, "colmap_keep_going", False),
    ).process(args)
    return 0


if __name__ == "__main__":
    sys.exit(main(COLMAPParams().parse_args()))
