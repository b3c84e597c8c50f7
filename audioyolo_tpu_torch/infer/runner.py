"""Directory inference (port of ``audioyolo_tpu/infer/runner.py``).

Files at the model's input rate go through :func:`evaluate_files_batched`,
which fills every device batch with windows of as many files as it takes.
Files at other rates, and files whose header cannot be read, go through
:func:`evaluate_audio` on a thread pool of ``num_concurrency`` threads that
share one resampler cache, so the decode of the next files overlaps the
device work of the current ones; an unreadable file raises after the others
are written. The threads call one ``infer_fn`` at once: each launches on the
device's default stream, and the kernel wrappers allocate per call.
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable, Dict

from ..data.wavio import read_wav_info
from .streaming import evaluate_audio, evaluate_files_batched


def evaluate_dir(
    infer_fn: Callable,
    audio_dir: str,
    output_dir: str,
    extension: str = "wav",
    num_concurrency: int = 10,
    verbose: bool = True,
    **kwargs,
) -> int:
    """Write one CSV per ``*.<extension>`` file of ``audio_dir`` under
    ``output_dir``; ``kwargs`` are :func:`evaluate_audio`'s. Returns the
    number of files."""
    paths = sorted(glob.glob(os.path.join(audio_dir, f"*.{extension}")))
    os.makedirs(output_dir, exist_ok=True)
    resampler_cache: Dict = {}

    native_rate = []
    for p in paths:
        try:
            rate = read_wav_info(p)[0]
        except Exception:  # any header fault; evaluate_audio raises it after the rest
            continue
        if rate == kwargs["input_sample_rate"]:
            native_rate.append(p)
    done = 0
    if len(native_rate) > 1:
        done = evaluate_files_batched(
            infer_fn, native_rate, output_dir,
            input_sample_rate=kwargs["input_sample_rate"],
            sample_duration=kwargs["sample_duration"],
            batch_size=kwargs["batch_size"],
            idx2class_map=kwargs["idx2class_map"],
            frame_fn=kwargs.get("frame_fn"),
            verbose=verbose,
            transfer=kwargs.get("transfer", "int16"),
        )
        batched = set(native_rate)
        paths = [p for p in paths if p not in batched]

    if not paths:
        return done
    threaded_done = 0
    with ThreadPoolExecutor(max_workers=max(1, num_concurrency)) as pool:
        futures = {
            pool.submit(evaluate_audio, infer_fn, path, output_dir,
                        _resampler_cache=resampler_cache, **kwargs): path
            for path in paths
        }
        for fut in as_completed(futures):
            fut.result()  # propagate worker exceptions
            threaded_done += 1
            if verbose:
                print(f"[{threaded_done}/{len(paths)}] {os.path.basename(futures[fut])}")
    return done + threaded_done
