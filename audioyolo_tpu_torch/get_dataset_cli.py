"""Dataset preparation of the PyTorch port (port of the root ``get_dataset.py``).

Usage::

    python -m audioyolo_tpu_torch.get_dataset_cli [--root dataset] [--name openbmat]
        [--url KAGGLE_URL] [--format_only] [--target_sample_rate 22050]
        [--num_concurrency 4] [--seed 42] [--device cuda]

Optionally downloads a Kaggle dataset (the ``kaggle`` package is imported
only for ``--url``, and its absence ends the run with a ``SystemExit`` that
says what to do instead), splits the audio files 80/20 into ``train/`` and
``eval/`` (``random.seed(seed)``, then ``random.sample``), moves the
annotation JSONs into ``annotations/``, removes everything else in the
dataset folder, and resamples every WAV in place to the target rate with the
port's band-limited resampler (``ops/resample.py``) on ``--device`` (the
CUDA card by default), ``--num_concurrency`` files at a time. ``--format_only``
skips the download and the split and only resamples. Non-WAV files (mp3,
...) are converted with ffmpeg where it is on ``PATH``; without it they are
reported and skipped.
"""

from __future__ import annotations

import argparse
import glob
import logging
import math
import os
import random
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .data.wavio import read_wav, write_wav
from .device import DeviceLike, resolve_device
from .ops.resample import Resampler

logger = logging.getLogger(__name__)


def _have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def resample(audio: np.ndarray, orig: int, new: int, device: DeviceLike = None) -> np.ndarray:
    """``audio`` (channels, frames) float32 at ``orig`` Hz -> float32 at ``new``
    Hz, resampled on ``device`` (default: the card)."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev)
    return Resampler(orig, new).to(dev)(x).cpu().numpy()


def convert_audio(path: str, dest_ext: str = "wav", target_sample_rate: int = 22050,
                  device: DeviceLike = None) -> None:
    ext = path.rsplit(".", 1)[-1].lower()
    if ext != "wav":
        if not _have_ffmpeg():
            logger.warning("skipping %s: no ffmpeg available to decode .%s", path, ext)
            return
        out = path[: -(len(ext) + 1)] + f".{dest_ext}"
        subprocess.run(["ffmpeg", "-y", "-i", path, "-ar", str(target_sample_rate), out],
                       check=True, capture_output=True)
        os.remove(path)
        return
    audio, sr = read_wav(path)
    if sr == target_sample_rate:
        return
    write_wav(path, resample(audio, sr, target_sample_rate, device), target_sample_rate)


def glob_all_exts(root: str, exts, recursive: bool = True):
    files = []
    for ext in exts:
        files += glob.glob(os.path.join(root, "**", f"*.{ext}"), recursive=recursive)
    return files


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Dataset downloader / formatter (PyTorch port)")
    parser.add_argument("--url", type=str, default="", metavar="", help="Kaggle dataset URL")
    parser.add_argument("--name", type=str, default="openbmat", metavar="")
    parser.add_argument("--to_ext", type=str, default="wav", metavar="")
    parser.add_argument("--target_sample_rate", type=int, default=22050, metavar="")
    parser.add_argument("--num_concurrency", type=int, default=4, metavar="")
    parser.add_argument("--format_only", action="store_true")
    parser.add_argument("--seed", type=int, default=42, metavar="")
    parser.add_argument("--root", type=str, default="dataset", metavar="",
                        help="parent directory for the dataset folder")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    dataset_dir = os.path.join(args.root, args.name)
    supported = ["mp3", "wav"]

    if not args.format_only:
        if args.url:
            try:
                import kaggle
            except ImportError as e:
                raise SystemExit(
                    "the kaggle package is not installed in this environment; "
                    "download the dataset manually into "
                    f"{dataset_dir} and re-run with --format_only"
                ) from e
            os.makedirs(dataset_dir, exist_ok=True)
            kaggle.api.dataset_download_cli(args.url.split("datasets/")[-1], path=dataset_dir,
                                            unzip=True)
        if not os.path.exists(dataset_dir):
            raise OSError(f"path: {dataset_dir} does not exist")

        audio_files = glob_all_exts(dataset_dir, supported)
        annotation_files = glob.glob(os.path.join(dataset_dir, "**", "*.json"), recursive=True)
        random.seed(args.seed)
        n_train = math.ceil(0.8 * len(audio_files))
        train_files = set(random.sample(audio_files, n_train))

        for sub in ("train", "eval", "annotations"):
            os.makedirs(os.path.join(dataset_dir, sub), exist_ok=True)
        for f in audio_files:
            dest = "train" if f in train_files else "eval"
            if os.path.dirname(f) != os.path.join(dataset_dir, dest):
                shutil.move(f, os.path.join(dataset_dir, dest))
        for f in annotation_files:
            if os.path.dirname(f) != os.path.join(dataset_dir, "annotations"):
                shutil.move(f, os.path.join(dataset_dir, "annotations"))
        for d in os.listdir(dataset_dir):
            if d not in ("train", "eval", "annotations"):
                p = os.path.join(dataset_dir, d)
                shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)

    files = glob_all_exts(dataset_dir, supported)
    with ThreadPoolExecutor(max_workers=args.num_concurrency) as pool:
        list(pool.map(lambda f: convert_audio(f, args.to_ext, args.target_sample_rate, device),
                      files))
    print(f"prepared {len(files)} files under {dataset_dir}")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
