"""CLI of the PyTorch port: the flags of ``lcgan_tpu.cli`` (the reference's 33,
main.py:12-61, plus the JAX package's extensions) and ``--device``.

    python -m lcgan_torch.cli --phase fake_image_generation --model_name <run dir>
    torchrun --nproc_per_node=N -m lcgan_torch.cli --phase train ...   # data parallel, one GPU a rank

Non-train phases reload the run's ``args.txt``; explicitly typed flags win.
Runs on CUDA unless ``--device cpu`` is given, and raises if no GPU is present.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from lcgan_torch.config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PyTorch/CUDA implementation of LC-GAN")

    p.add_argument("--phase", type=str, default="train",
                   help="one of: train | fid_eval | fake_image_generation | video_generation")
    p.add_argument("--best", default=False, action="store_true",
                   help="restore the best-FID snapshot instead of the latest")

    p.add_argument("--tau", type=float, default=0.05,
                   help="temperature of the InfoNCE contrastive term")
    p.add_argument("--l_adv", type=float, default=1.0,
                   help="adversarial-loss weight (parsed but unused, as in the reference)")
    p.add_argument("--l_aux", type=float, default=0.5,
                   help="contrastive (auxiliary) loss weight")
    p.add_argument("--l_r1", type=float, default=10.0,
                   help="R1 gradient-penalty weight")
    p.add_argument("--l_s", type=float, default=0.0000001,
                   help="L1 sparsity weight on the mapping nets' diagonal factors")

    p.add_argument("--max_flow_scale", type=float, default=0.1,
                   help="cap on the per-block warp flow magnitude")
    p.add_argument("--geo_noise_dim", type=int, default=64, help="geometry z-space size")
    p.add_argument("--app_noise_dim", type=int, default=64, help="appearance z-space size")
    p.add_argument("--geo_projection_dim", type=int, default=256,
                   help="geometry embedding size of the D projection head")
    p.add_argument("--app_projection_dim", type=int, default=256,
                   help="appearance embedding size of the D projection head")
    p.add_argument("--geo_latent_dim", type=int, default=64, help="geometry w-space size")
    p.add_argument("--app_latent_dim", type=int, default=512, help="appearance w-space size")

    p.add_argument("--epoch", type=int, default=100000,
                   help="total training iterations (the reference calls one batch an 'epoch')")
    p.add_argument("--batch_size", type=int, default=32,
                   help="global batch, split across devices")
    p.add_argument("--g_lr", type=float, default=0.002, help="generator Adam step size")
    p.add_argument("--d_lr", type=float, default=0.002, help="discriminator Adam step size")
    p.add_argument("--beta1", type=float, default=0.0, help="Adam first-moment coefficient")
    p.add_argument("--beta2", type=float, default=0.99, help="Adam second-moment coefficient")
    p.add_argument("--g_ema_decay", type=float, default=0.9999,
                   help="generator weight-averaging decay")
    p.add_argument("--g_ema_start", type=int, default=0,
                   help="iteration at which EMA averaging kicks in (plain copy before)")
    p.add_argument("--freezeD_start", type=int, default=100000,
                   help="iteration at which the early D layers stop updating")
    p.add_argument("--freezeD_layer", type=int, default=5,
                   help="how many leading D blocks freezeD locks")

    p.add_argument("--img_resolution", type=int, default=256,
                   help="output image side length (256/512/1024)")
    p.add_argument("--img_ch", type=int, default=3, help="output channel count")
    p.add_argument("--psi", type=float, default=2.0,
                   help="z-space sweep amplitude for demo videos")
    p.add_argument("--w_psi", type=float, default=1.0,
                   help="w-space truncation strength at inference (<=0: training mode)")

    p.add_argument("--dataset_path", type=str, default="./",
                   help="root containing the train/ image folder")
    p.add_argument("--model_name", type=str, default="",
                   help="run directory (holds model/, samples/, logs)")
    p.add_argument("--save_dir", type=str, default="model",
                   help="checkpoint subdirectory inside the run dir")
    p.add_argument("--sample_dir", type=str, default="samples",
                   help="monitor-output subdirectory inside the run dir")

    p.add_argument("--num_fakes", type=int, default=10,
                   help="batches of fake images to write in fake_image_generation")
    p.add_argument("--ctrl_dim", type=int, default=-1,
                   help="latent dimension swept by video_generation (-1: all of them)")
    p.add_argument("--num_videos", type=int, default=10,
                   help="videos rendered per controlled dimension")

    p.add_argument("--save_interval", type=int, default=5000,
                   help="iterations between checkpoint snapshots")
    p.add_argument("--print_interval", type=int, default=100,
                   help="iterations between log.txt lines")
    p.add_argument("--show_interval", type=int, default=1000,
                   help="iterations between sweep-video monitors")

    # --- extensions shared with lcgan_tpu ---
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="conv compute dtype (params stay fp32)")
    p.add_argument("--seed", type=int, default=0, help="global RNG seed")
    p.add_argument("--inception_weights", type=str, default="",
                   help="path to pytorch-fid pt_inception .pth for FID eval")
    p.add_argument("--remat_blocks", default=True, action=argparse.BooleanOptionalAction,
                   help="JAX package only: rematerialize G/D blocks in backward")
    p.add_argument("--remat_save_g_convs", default=True, action=argparse.BooleanOptionalAction,
                   help="JAX package only: save G conv outputs under remat")
    p.add_argument("--remat_save_d_convs", default=True, action=argparse.BooleanOptionalAction,
                   help="JAX package only: save D conv outputs under remat")
    p.add_argument("--remat_save_max_res", type=int, default=1024,
                   help="JAX package only: largest map the conv-save remat policies apply to")
    p.add_argument("--view_batched_steps", default=False, action=argparse.BooleanOptionalAction,
                   help="fuse the even iteration's per-view G/D applications into batched ones")
    p.add_argument("--base_nf", type=int, default=None,
                   help="override the per-resolution channel base (tiny models / ablations)")
    p.add_argument("--max_nf", type=int, default=512, help="channel cap per block")
    p.add_argument("--mbstd_group_size", type=int, default=8,
                   help="minibatch-std group size in the D epilogue")
    p.add_argument("--adam_eps", type=float, default=1e-8, help="Adam epsilon")
    p.add_argument("--num_data_workers", type=int, default=4, help="host data worker threads")
    p.add_argument("--distributed", type=str, default="auto", choices=["auto", "on", "off"],
                   help="join the process group of a torchrun launch (one process per GPU, NCCL; "
                        "gloo with --device cpu): 'auto' when torchrun's environment is present, "
                        "'on' to require it, 'off' never")
    p.add_argument("--warp_impl", type=str, default="auto",
                   choices=["auto", "pallas", "banded", "none"],
                   help="bicubic-warp route: auto/pallas as the JAX package routes its Pallas "
                        "kernels (on the card, maps of at most 64² that its rule sends to the "
                        "small-map kernels run the small-map CUDA kernels); banded keeps the "
                        "general CUDA kernels in the port; none: skip the warp (diagnostic "
                        "ablations only, as in the JAX package)")
    p.add_argument("--warp_pallas_min_res", type=int, default=128,
                   help="smallest map that auto routes to the Pallas kernels (the port: to the "
                        "small-map CUDA kernels where they apply, e.g. 8 for the 8²-64² blocks)")
    p.add_argument("--warp_adaptive_band", default=True, action=argparse.BooleanOptionalAction,
                   help="JAX package only: flow-adaptive band of the Pallas warp")
    p.add_argument("--profile_dir", type=str, default="", help="JAX package only: trace output dir")

    # --- the port's own ---
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on the GPU (default; raises if none is present) or the CPU")
    return p


def _explicit_flags(argv=None) -> dict:
    """The flags the user actually typed (re-parse with SUPPRESS defaults)."""
    p = build_parser()
    for action in p._actions:
        action.default = argparse.SUPPRESS
    return vars(p.parse_args(argv))


def parse_config(argv=None) -> Config:
    args = build_parser().parse_args(argv)
    fields = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in vars(args).items() if k in fields})
    # Eval/generation phases reload the run's args.txt so model-geometry flags
    # never have to be retyped to match the checkpoint; typed flags still win.
    args_txt = os.path.join(cfg.model_name, "args.txt") if cfg.model_name else ""
    if cfg.phase != "train" and args_txt and os.path.exists(args_txt):
        cfg = Config.load(args_txt)
        cfg.phase = args.phase
        for k, v in _explicit_flags(argv).items():
            if k in fields:
                setattr(cfg, k, v)
    cfg.validate()
    return cfg


def main(argv=None):
    cfg = parse_config(argv)
    print(cfg)
    from lcgan_torch.train.loop import run_phase

    run_phase(cfg)


if __name__ == "__main__":
    main()
