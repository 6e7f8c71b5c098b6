"""PNG-directory importer (counterpart of data/preprocess.py), a host-only
step.

Port of the reference's preprocess.py:7-51: reads the
RGB/Normals/Depth/Albedos/GroundTruth PNG directories (the reference's
data_gen layout), resizes everything to ``op_size`` squared (cv2 if it
imports, else PIL; with neither the ``ImportError`` stands), rescales with
the reference's constants (image/255, normal/100, depth/10, albedo/255,
gt/255) and writes (H, W, 10) input and (H, W, 3) gt npy pairs, so
reference-generated datasets train this package's denoiser unchanged.
"""
from __future__ import annotations

import os

import numpy as np

from ..utils.imageio import read_png


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    try:
        import cv2
        return cv2.resize(img, (size, size))
    except ImportError:
        from PIL import Image
        return np.asarray(Image.fromarray(img).resize((size, size)))


def preprocess_png_dirs(root_dir: str, rgb_dir: str, depth_dir: str,
                        albedo_dir: str, normal_dir: str, gt_dir: str,
                        op_size: int = 512):
    """PNG dirs -> {root}/input/*.npy + {root}/gt/*.npy (preprocess.py:7-51).
    Files pair up by sorted name; returns the two output directories."""
    os.makedirs(os.path.join(root_dir, "input"), exist_ok=True)
    os.makedirs(os.path.join(root_dir, "gt"), exist_ok=True)
    images = sorted(os.listdir(rgb_dir))
    normals = sorted(os.listdir(normal_dir))
    depths = sorted(os.listdir(depth_dir))
    albedos = sorted(os.listdir(albedo_dir))
    gts = sorted(os.listdir(gt_dir))
    for index in range(len(images)):
        image = _resize(read_png(os.path.join(rgb_dir, images[index])), op_size)
        gt = _resize(read_png(os.path.join(gt_dir, gts[index])), op_size)
        normal = _resize(read_png(os.path.join(normal_dir, normals[index])), op_size)
        albedo = _resize(read_png(os.path.join(albedo_dir, albedos[index])), op_size)
        depth = read_png(os.path.join(depth_dir, depths[index]))
        if depth.ndim == 3:
            depth = depth[..., 0]
        depth = _resize(depth, op_size)[..., None]

        inputs = np.zeros((op_size, op_size, 10), np.float32)
        inputs[:, :, :3] = image.astype(np.float32) / 255.0
        inputs[:, :, 3:6] = normal.astype(np.float32) / 100.0
        inputs[:, :, 6:7] = depth.astype(np.float32) / 10.0
        inputs[:, :, 7:] = albedo.astype(np.float32) / 255.0
        outputs = gt.astype(np.float32) / 255.0

        stem = images[index][:-4]
        np.save(os.path.join(root_dir, "input", stem), inputs)
        np.save(os.path.join(root_dir, "gt", stem), outputs)
    return os.path.join(root_dir, "input"), os.path.join(root_dir, "gt")
