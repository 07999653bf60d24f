from siss_tpu_torch.utils.convert import load_flax_params, params_from_flax

__all__ = ["load_flax_params", "params_from_flax"]
