from repro_torch.configs.registry import (concrete_inputs, get_config,
                                          input_specs, list_archs)

__all__ = ["concrete_inputs", "get_config", "input_specs", "list_archs"]
