"""Standalone generation CLI: checkpoint -> audio.

    python -m movenet_tpu_torch.generate --checkpoint <run_dir> \
        --dataset /path/to/kinetics --n_samples 160000 \
        --temperature 1.0 --out generated/

The counterpart of ``movenet_tpu.generate``: load the parameters of a run
directory (``checkpoints/<step>/params.npz`` plus its ``config.json``),
take prompts from validation clips (``--dataset``: the first RF codes of
each clip, its video unless ``--use_video 0``, and its class label for a
model with global conditioning) or RF frames of mu-law silence, and
synthesize waveforms with the fastest applicable sampler:

  * a model on a CUDA device, batch 1, 2, 4 or 8 -> the AR sampler kernel,
    video-conditioned when the prompts bring video (``--speculative 1``:
    the speculative kernel for B=1 decoding without video, same codes);
  * otherwise                                    -> the cached sampler.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import torch

from movenet_tpu_torch.config import TrainingConfig
from movenet_tpu_torch.models.convert import load_jax_params
from movenet_tpu_torch.models.wavenet import WaveNet, make_wavenet
from movenet_tpu_torch.train.checkpoint import restore_params

logger = logging.getLogger(__name__)


def load_checkpoint_model(checkpoint_dir: Path, device="cuda"):
    """(model, config, step) from a run directory: ``config.json`` gives
    the architecture, the latest ``checkpoints/<step>/params.npz`` the
    weights.  The model is on ``device``, in eval mode; a CUDA device
    that is not there raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available (pass device='cpu' to load on the CPU)")
    checkpoint_dir = Path(checkpoint_dir)
    config = TrainingConfig.load(checkpoint_dir / "config.json")
    params, step = restore_params(checkpoint_dir)
    model: WaveNet = load_jax_params(make_wavenet(config.model_config),
                                     params)
    model = model.to(torch.device(device)).eval()
    logger.info("restored step-%d params from %s", step, checkpoint_dir)
    return model, config, step


def first_batch(dataset_fp, mc, batch_size: int, use_video: bool):
    """The first validation batch of ``dataset_fp`` in index order: the
    port's ``Batch`` of CPU tensors (codes, video, labels)."""
    from movenet_tpu_torch.data.pipeline import get_dataloader

    loader = get_dataloader(
        dataset_fp, input_channels=mc.input_channels,
        batch_size=batch_size, train=False, use_video=use_video,
        shuffle=False, num_workers=2,
        max_audio_frames=mc.max_audio_frames,
        max_video_frames=mc.max_video_frames)
    epoch = loader.epoch(0)
    try:
        return next(epoch)
    except StopIteration:
        raise ValueError(
            f"{dataset_fp} has fewer than {batch_size} readable validation "
            "clips") from None
    finally:
        epoch.close()  # stops the loader's producer thread


def sampler_route(device: torch.device, batch: int, speculative: bool,
                  has_video: bool) -> str:
    """Which sampler generation takes: "speculative" (B=1 without video,
    when asked for) or "kernel" (the AR kernel, video-conditioned or
    not) for a model on a CUDA device at B in {1, 2, 4, 8}; "cached"
    (``models/sampler.fast_generate``) otherwise."""
    if device.type != "cuda" or batch not in (1, 2, 4, 8):
        return "cached"
    if speculative and batch == 1 and not has_video:
        return "speculative"
    return "kernel"


def generate_from_checkpoint(
    checkpoint_dir: Path,
    dataset_fp: str = None,
    n_samples: int = None,
    temperature: float = 1.0,
    batch_size: int = 1,
    use_video: bool = None,
    out_dir: Path = Path("generated"),
    seed: int = 0,
    parity_sampling: bool = True,
    fast: bool = True,
    speculative: bool = False,
    spec_order: int = 3,
    spec_depth: int = 1,
    device="cuda",
):
    """Generate ``batch_size`` clips from a checkpoint and write them with
    ``export_samples``; returns kind -> written paths.  ``device``
    defaults to the CUDA device; without one it raises, and the CPU runs
    only when the caller asks for it (``device="cpu"``)."""
    from movenet_tpu_torch.models.sampler import fast_generate
    from movenet_tpu_torch.ops import jax_random, mu_law_encode
    from movenet_tpu_torch.ops.cuda.ar_sampler import cuda_generate
    from movenet_tpu_torch.utils.samples import export_samples

    device = torch.device(device)
    model, config, step = load_checkpoint_model(checkpoint_dir, device)
    mc = config.model_config
    if use_video is None:
        use_video = config.use_video
    rf = model.receptive_fields
    n = int(n_samples or config.generate_n_samples or mc.max_audio_frames)
    if n <= rf:
        raise ValueError(f"n_samples ({n}) must exceed the receptive "
                         f"field ({rf})")

    # prompts: validation clips when a dataset is given, else silence
    video = labels = None
    if dataset_fp:
        batch = first_batch(dataset_fp, mc, batch_size, use_video)
        prompt = batch.codes[:, :rf].to(device)
        if use_video and batch.video is not None:
            video = batch.video.to(device)
        if model.global_classes and batch.labels is not None:
            labels = batch.labels.to(device)
    else:
        silent_code = int(mu_law_encode(torch.zeros(1),
                                        mc.input_channels)[0])
        prompt = torch.full((batch_size, rf), silent_code,
                            dtype=torch.int32, device=device)

    t0 = time.perf_counter()
    route = sampler_route(device, prompt.shape[0], speculative,
                          video is not None)
    if route != "cached":
        spec_ok = route == "speculative"
        codes = cuda_generate(model, prompt, n, temperature=temperature,
                              seed=seed, video=video, labels=labels,
                              parity_sampling=parity_sampling,
                              fast=fast, speculative=spec_ok,
                              spec_order=spec_order, spec_depth=spec_depth,
                              return_stats=spec_ok)
        if spec_ok:
            codes, hits = codes
            h, g = float(hits), n - rf
            # g - h is the iteration count at any spec_depth, so g/(g-h)
            # is the steps-per-iteration multiplier
            logger.info(
                "speculative decode: %d/%d samples from committed "
                "guesses (%.2fx steps/iteration)", int(h), g,
                g / max(1.0, g - h))
    else:
        codes = fast_generate(model, prompt, n, temperature=temperature,
                              rng=jax_random.PRNGKey(seed), video=video,
                              labels=labels,
                              parity_sampling=parity_sampling)
    codes = codes.cpu().numpy()
    dt = time.perf_counter() - t0
    n_new = (n - rf) * codes.shape[0]
    logger.info("sample generation took %.2f seconds "
                "(%.0f samples/sec incl build)", dt, n_new / dt)

    model_rate = max(1, int(16_000 * mc.max_audio_frames / 160_000))
    written = export_samples(out_dir, step, "generate",
                             {"generated": codes, "prompt": codes[:, :rf]},
                             mc.input_channels, model_rate=model_rate)
    return written


def main(argv=None):
    """Run the CLI; prints and returns the written paths by kind."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s: %(levelname)s: %(message)s")
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", type=Path, required=True,
                    help="run directory containing checkpoints/ and "
                         "config.json")
    ap.add_argument("--dataset", type=str, default=None,
                    help="prompts (and video, labels) from the validation "
                         "clips of this dataset tree")
    ap.add_argument("--n_samples", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--use_video", type=lambda x: bool(int(x)),
                    default=None,
                    help="condition on the clips' video (default: the "
                         "run's use_video)")
    ap.add_argument("--parity_sampling", type=lambda x: bool(int(x)),
                    default=True)
    ap.add_argument("--fast_sampler", type=lambda x: bool(int(x)),
                    default=True,
                    help="short-critical-path kernel (1: default); "
                         "0 = exact-chain kernel")
    ap.add_argument("--speculative", type=lambda x: bool(int(x)),
                    default=False,
                    help="B=1 without video only: speculative-wavefront "
                         "kernel (same codes, hit-rate-dependent speedup "
                         "on trained models)")
    ap.add_argument("--spec_order", type=int, default=3, choices=(2, 3),
                    help="speculative guesser order: 3 = learned (C,C) "
                         "pair table with 2-gram fallback (default), 2 = "
                         "learned successor column")
    ap.add_argument("--spec_depth", type=int, default=1, choices=(1, 2),
                    help="speculative chains per iteration beyond the "
                         "real one (2 commits up to 3 samples/iter on "
                         "double hits; default 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=Path("generated"))
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the model (default: cuda; "
                         "raises without a CUDA device, cpu only when "
                         "asked for)")
    args = ap.parse_args(argv)
    written = generate_from_checkpoint(
        args.checkpoint, args.dataset, args.n_samples, args.temperature,
        args.batch_size, args.use_video, args.out, args.seed,
        args.parity_sampling, fast=args.fast_sampler,
        speculative=args.speculative, spec_order=args.spec_order,
        spec_depth=args.spec_depth, device=args.device)
    for kind, paths in written.items():
        for p in paths:
            print(p)
    return written


if __name__ == "__main__":
    main()
