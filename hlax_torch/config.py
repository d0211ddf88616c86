"""Config / CLI flag surface (port of ``hlax/config.py``).

Same flag names, defaults and ``--f=<file>`` config-file loading as hlax and
the reference's parse_model_args.py:9-120 (newline-separated
``--key=value`` lines, Python-literal kernel specs via ast.literal_eval), so
a config file parses to the same option dict in both packages.  Flags whose
feature the port has not reached yet are still parsed; ``hlax_torch.cli.main``
refuses the ones that would change what a run does.
"""

from __future__ import annotations

import argparse
import ast


class LoadFromFile(argparse.Action):
    """Read parameters from a config file (parse_model_args.py:9-15)."""

    def __call__(self, parser, namespace, values, option_string=None):
        with values as f:
            parser.parse_args(f.read().splitlines(), namespace)


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


class ModelArgs:
    """Runtime parameters (parse_model_args.py:18-109 + TPU additions)."""

    def __init__(self):
        p = argparse.ArgumentParser(
            description="Enter configuration arguments for the model")
        self.parser = p
        add = p.add_argument

        add("--data_source_path", type=str, default="./data")
        add("--save_path", type=str, default="./results")
        add("--csv_file_data", type=str, required=False)
        add("--csv_file_test_data", type=str, required=False)
        add("--csv_file_label", type=str, required=False)
        add("--csv_file_test_label", type=str, required=False)
        add("--csv_file_prediction_data", type=str, required=False)
        add("--csv_file_prediction_label", type=str, required=False)
        add("--csv_types_file", type=str, required=False)
        add("--true_mask_file", type=str, default="")
        add("--true_test_mask_file", type=str, default="")
        add("--true_prediction_mask_file", type=str, default="")
        add("--true_validation_mask_file", type=str, default="")
        add("--true_generation_mask_file", type=str, default="")
        add("--csv_file_validation_data", type=str, required=False)
        add("--csv_file_validation_label", type=str, required=False)
        add("--csv_file_generation_data", type=str, required=False)
        add("--csv_file_generation_label", type=str, required=False)
        add("--mask_file", type=str, default=None)
        add("--test_mask_file", type=str, default=None)
        add("--prediction_mask_file", type=str, default=None)
        add("--validation_mask_file", type=str, default=None)
        add("--generation_mask_file", type=str, default=None)
        add("--csv_range_file", type=str, required=False)
        add("--dataset_type", required=False,
            choices=["RotatedMNIST", "HealthMNIST", "Physionet",
                     "Physionet2019", "HeteroHealthMNIST", "PPMI"])
        add("--latent_dim", type=int, default=2)
        add("--hidden_dim", type=int, default=64)
        add("--hidden_layers", type=str)
        add("--id_covariate", type=int)
        add("--M", type=int)
        add("--P", type=int)
        add("--T", type=int)
        add("--varying_T", type=str2bool, default=False)
        add("--epochs", type=int, default=1000)
        add("--weight", type=float, default=1)
        add("--num_dim", type=int, required=False)
        add("--y_dim", type=int, required=False)
        add("--num_samples", type=int, default=1)
        add("--type_KL", required=False,
            choices=["closed", "other", "GPapprox", "GPapprox_closed"])
        add("--constrain_scales", type=str2bool, default=False)
        add("--model_params", type=str, default="model_params.pth")
        add("--gp_model_folder", type=str, default="./pretrainedVAE")
        add("--generate_plots", type=str2bool, default=False)
        add("--iter_num", type=int, default=1)
        add("--test_freq", type=int, default=50)
        add("--cat_kernel", type=ast.literal_eval)
        add("--bin_kernel", type=ast.literal_eval)
        add("--sqexp_kernel", type=ast.literal_eval)
        add("--cat_int_kernel", type=ast.literal_eval)
        add("--bin_int_kernel", type=ast.literal_eval)
        add("--covariate_missing_val", type=ast.literal_eval)
        add("--run_tests", type=str2bool, default=False)
        add("--run_validation", type=str2bool, default=False)
        add("--generate_images", type=str2bool, default=False)
        add("--results_path", type=str, required=False)
        add("--f", type=open, action=LoadFromFile)
        add("--variational_inference_training", type=str2bool, default=False)
        add("--memory_dbg", type=str2bool, default=False)
        add("--natural_gradient", type=str2bool, default=True)
        add("--natural_gradient_lr", type=float, default=0.01)
        add("--subjects_per_batch", type=int, default=20)
        add("--save_interval", type=int, default=100)
        add("--vy_init_real", type=float, default=1.0)
        add("--vy_init_pos", type=float, default=0.5)
        add("--logvar_network", type=str2bool, default=False)
        add("--conv_hivae", type=str2bool, default=False)
        add("--conv_range", type=int, default=255)
        add("--early_stopping", type=str2bool, default=False)
        add("--use_ranges", type=str2bool, default=False)

        # hlax additions (absent from the reference); same names and
        # defaults as hlax/config.py
        add("--gp_dtype", type=str, default="float32",
            choices=["float32", "float64"])
        add("--model_dtype", type=str, default="float32",
            choices=["float32", "bfloat16", "float64"])
        add("--compute_dtype", type=str, default="",
            choices=["", "bfloat16"])
        add("--data_parallel", type=int, default=0)
        add("--latent_parallel", type=int, default=1)
        add("--device", type=str, default="",
            choices=["", "cpu", "cuda"],
            help="device to train on (empty = cuda)")
        add("--profile_dir", type=str, default="")
        add("--epochs_per_dispatch", type=int, default=1)
        add("--scan_unroll", type=int, default=1)
        add("--seed", type=int, default=0)
        add("--eps", type=float, default=None,
            help="GP jitter (default: 1e-6 for float64, 1e-4 for float32)")
        add("--nat_grad_f64", type=str2bool, default=False)
        add("--nat_grad_jitter", type=float, default=0.0,
            help="relative diagonal ridge on iH before its Cholesky in the "
                 "natural-gradient update")
        add("--fused_conv", type=str2bool, default=False)
        add("--use_pallas_chol", type=str2bool, default=True,
            help="the Cholesky kernels (floored pivots) in the training "
                 "bound and the natural-gradient update; False: the "
                 "library's unguarded Cholesky, as hlax's XLA path")
        add("--eval_gp_f64", type=str2bool, default=False)

    def parse_options(self, argv=None):
        return vars(self.parser.parse_args(argv))
