"""Compare two held-out ``eval.json`` records of the same scene pool and
say which model wins: the gate for swapping the shipped artifact (copy of
the repository's tools/compare_evals.py; standard library only).

    python -m ai_path_tracer_denoiser_tpu_torch.tools.compare_evals runs/r2/eval.json runs/r3/eval.json
"""
import json
import sys


def main(argv=None):
    a_path, b_path = (sys.argv[1:] if argv is None else argv)[:2]
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    scenes = sorted(set(a) & set(b))
    wins = 0
    print(f"{'scene':8s} {'A psnr':>8s} {'B psnr':>8s} {'A mse-x':>8s} "
          f"{'B mse-x':>8s}")
    for s in scenes:
        pa, pb = a[s]["psnr_denoised"], b[s]["psnr_denoised"]
        ia = a[s]["mse_noisy"] / max(a[s]["mse_denoised"], 1e-12)
        ib = b[s]["mse_noisy"] / max(b[s]["mse_denoised"], 1e-12)
        wins += pb > pa
        print(f"{s:8s} {pa:8.2f} {pb:8.2f} {ia:8.1f} {ib:8.1f}")
    n = len(scenes)

    def mean(d, k):
        return sum(d[s][k] for s in scenes) / n

    print(f"{'mean':8s} {mean(a, 'psnr_denoised'):8.2f} "
          f"{mean(b, 'psnr_denoised'):8.2f}")
    verdict = "B" if wins == n else ("A" if wins == 0 else "mixed")
    print(f"B beats A on {wins}/{n} scenes -> {verdict}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
