from .options import Options, check_run_dir, load_options
