"""Global CMVN statistics over a data.list.

A multiprocessing map-reduce of each wav's fbank sums and squared sums
(``fbank_numpy`` at dither 0, after resampling to ``--sample_rate``),
written as the JSON ``{mean_stat, var_stat, frame_num}`` that
``models/cmvn.load_cmvn_stats`` reads. With more than one worker the sums
arrive in any order, so the float64 statistics agree between runs to about
1e-12 relative; ``frame_num`` is exact.

    python -m conformer_tpu_torch.tools.compute_cmvn_stats \\
        --data_list data/train-960/data.list --output data/train-960/global_cmvn
"""

from __future__ import annotations

import argparse
import json
from multiprocessing import Pool

import numpy as np

from ..data.audio import load_audio, resample
from ..ops.fbank import fbank_numpy


def _stats_for(args: tuple[str, int, int]) -> tuple[np.ndarray, np.ndarray, int]:
    path, num_mel_bins, sr = args
    wav, orig_sr = load_audio(path)
    if orig_sr != sr:
        wav = resample(wav, orig_sr, sr)
    feat = fbank_numpy(wav * (1 << 15), sample_rate=sr, num_mel_bins=num_mel_bins,
                       dither=0.0).astype(np.float64)
    return feat.sum(0), (feat**2).sum(0), feat.shape[0]


def compute(
    data_list: str,
    output: str,
    num_mel_bins: int = 80,
    sample_rate: int = 16000,
    num_workers: int = 2,
) -> dict:
    """Write the statistics of every wav of ``data_list`` to ``output``;
    returns them."""
    paths = []
    with open(data_list) as f:
        for line in f:
            line = line.strip()
            if line:
                paths.append(json.loads(line)["wav_path"])

    mean_stat = np.zeros(num_mel_bins)
    var_stat = np.zeros(num_mel_bins)
    frames = 0
    jobs = [(p, num_mel_bins, sample_rate) for p in paths]
    if num_workers > 1:
        with Pool(num_workers) as pool:
            results = list(pool.imap_unordered(_stats_for, jobs, chunksize=16))
    else:
        results = map(_stats_for, jobs)
    for m, v, n in results:
        mean_stat += m
        var_stat += v
        frames += n

    stats = {"mean_stat": mean_stat.tolist(), "var_stat": var_stat.tolist(),
             "frame_num": frames}
    with open(output, "w") as f:
        json.dump(stats, f)
    return stats


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_list", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--num_mel_bins", type=int, default=80)
    ap.add_argument("--sample_rate", type=int, default=16000)
    ap.add_argument("--num_workers", type=int, default=2)
    args = ap.parse_args(argv)
    stats = compute(args.data_list, args.output, args.num_mel_bins, args.sample_rate,
                    args.num_workers)
    print(f"frames: {stats['frame_num']} -> {args.output}")


if __name__ == "__main__":
    main()
