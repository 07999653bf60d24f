from siss_tpu_torch.config.core import Config, get_object, instantiate, load_config, to_dict

__all__ = ["Config", "get_object", "instantiate", "load_config", "to_dict"]
