from .options import Options, load_options
