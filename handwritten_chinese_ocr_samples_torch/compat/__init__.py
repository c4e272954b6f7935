from .torch_convert import (  # noqa: F401
    convert_checkpoint, convert_state_dict, load_pth_tar)
