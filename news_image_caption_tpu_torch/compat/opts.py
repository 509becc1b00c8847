"""The Gen-1 command line's flags.

Counterpart of `news_image_caption_tpu/compat/opts.py`: every flag of
the Gen-1 `train.py` with its name, type, default and checks, so that
`python -m news_image_caption_tpu_torch.compat.train --caption_model
show_attend_tell ...` takes a `train.py` command line. The data paths
default to None; without them `compat.train` trains on a synthetic
set (`--tpu_synthetic_size`, as the JAX package names it). `--platform
cpu` runs on the CPU; by default the command needs the card.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def parse_opt(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Gen-1 news captioner (PyTorch port)")
    # Data input settings
    p.add_argument("--input_json", type=str, default=None)
    p.add_argument("--input_label_h5", type=str, default=None)
    p.add_argument("--input_image_h5", type=str, default=None)
    p.add_argument("--cnn_model", type=str, default="resnet152")
    p.add_argument("--cnn_weight", type=str, default=None)
    p.add_argument("--start_from", type=str, default=None)
    # Model settings
    p.add_argument("--caption_model", type=str, default="show_attend_tell",
                   help="show_tell | show_attend_tell | all_img | fc | "
                        "att2in | att2in2 | adaatt | adaatt_mo | topdown")
    p.add_argument("--rnn_size", type=int, default=512)
    p.add_argument("--num_layers", type=int, default=1)
    p.add_argument("--rnn_type", type=str, default="lstm")
    p.add_argument("--input_encoding_size", type=int, default=512)
    p.add_argument("--att_hid_size", type=int, default=512)
    p.add_argument("--fc_feat_size", type=int, default=2048)
    p.add_argument("--att_feat_size", type=int, default=2048)
    # Sentence-embedding conditioning
    p.add_argument("--sentence_embed", type=str, default=None)
    p.add_argument("--sentence_embed_att", type=bool, default=True)
    p.add_argument("--sentence_embed_method", type=str, default="fc",
                   help="fc | fc_max | conv | conv_deep | bnews")
    p.add_argument("--sentence_length", type=int, default=54)
    p.add_argument("--sentence_embed_size", type=int, default=300)
    # Optimization: general
    p.add_argument("--max_epochs", type=int, default=150)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--grad_clip", type=float, default=5.0)
    p.add_argument("--num_thread", type=int, default=4)
    p.add_argument("--drop_prob_lm", type=float, default=0.2)
    p.add_argument("--finetune_cnn_after", type=int, default=-1)
    p.add_argument("--seq_per_img", type=int, default=1)
    p.add_argument("--beam_size", type=int, default=1)
    # Optimization: for the language model
    p.add_argument("--optim", type=str, default="adam")
    p.add_argument("--learning_rate", type=float, default=0.002)
    p.add_argument("--learning_rate_decay_start", type=int, default=30)
    p.add_argument("--learning_rate_decay_every", type=int, default=8)
    p.add_argument("--learning_rate_decay_rate", type=float, default=0.8)
    p.add_argument("--optim_alpha", type=float, default=0.8)
    p.add_argument("--optim_beta", type=float, default=0.999)
    p.add_argument("--optim_epsilon", type=float, default=1e-8)
    # Optimization: for the CNN
    p.add_argument("--cnn_optim", type=str, default="adam")
    p.add_argument("--cnn_optim_alpha", type=float, default=0.8)
    p.add_argument("--cnn_optim_beta", type=float, default=0.999)
    p.add_argument("--cnn_learning_rate", type=float, default=1e-5)
    p.add_argument("--cnn_weight_decay", type=float, default=0)
    # Scheduled sampling
    p.add_argument("--scheduled_sampling_start", type=int, default=-1)
    p.add_argument("--scheduled_sampling_increase_every", type=int,
                   default=5)
    p.add_argument("--scheduled_sampling_increase_prob", type=float,
                   default=0.05)
    p.add_argument("--scheduled_sampling_max_prob", type=float,
                   default=0.25)
    # Evaluation and checkpointing
    p.add_argument("--val_images_use", type=int, default=5000)
    p.add_argument("--save_checkpoint_every", type=int, default=1000)
    p.add_argument("--checkpoint_path", type=str, default="save/")
    p.add_argument("--language_eval", type=int, default=1)
    p.add_argument("--losses_log_every", type=int, default=100)
    p.add_argument("--load_best_score", type=int, default=1)
    p.add_argument("--id", type=str, default="")
    p.add_argument("--train_only", type=int, default=0)
    # Extensions kept out of the reference surface, named as the JAX
    # package names them.
    p.add_argument("--tpu_synthetic_size", type=int, default=0,
                   help="use a synthetic dataset of this size when no "
                        "HDF5 inputs are given (0 = require real data)")
    p.add_argument("--tpu_vocab_size", type=int, default=200)
    p.add_argument("--tpu_max_iters", type=int, default=0,
                   help="stop after N iterations (0 = epochs only)")
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="cpu: train on the CPU; default: the card")

    args = p.parse_args(argv)

    # The reference's checks.
    assert args.rnn_size > 0
    assert args.num_layers > 0
    assert args.input_encoding_size > 0
    assert args.batch_size > 0
    assert 0 <= args.drop_prob_lm < 1
    assert args.beam_size > 0
    assert args.save_checkpoint_every > 0
    assert args.losses_log_every > 0
    return args
