"""Global name → class registry for models and datasets.

Copy of `equihgnn_tpu/common/registry.py`, unchanged: the port resolves
model names as the JAX package does, from a registry of its own.

Same decorator API as the reference (`equihgnn/common/registry.py:1-41`):
duplicate registrations raise, lookups return None for unknown names and
`create_model`/`create_data` (package `__init__`) raise ValueError.
"""

from __future__ import annotations


class Registry:
    mapping: dict[str, dict[str, type]] = {
        "model_name_mapping": {},
        "data_name_mapping": {},
    }

    @classmethod
    def register_model(cls, name: str):
        def wrap(model_cls):
            if name in cls.mapping["model_name_mapping"]:
                raise KeyError(
                    f"Model name {name!r} already registered to "
                    f"{cls.mapping['model_name_mapping'][name].__name__}"
                )
            cls.mapping["model_name_mapping"][name] = model_cls
            return model_cls

        return wrap

    @classmethod
    def register_data(cls, name: str):
        def wrap(data_cls):
            if name in cls.mapping["data_name_mapping"]:
                raise KeyError(
                    f"Dataset name {name!r} already registered to "
                    f"{cls.mapping['data_name_mapping'][name].__name__}"
                )
            cls.mapping["data_name_mapping"][name] = data_cls
            return data_cls

        return wrap

    @classmethod
    def get_model_class(cls, name: str):
        return cls.mapping["model_name_mapping"].get(name, None)

    @classmethod
    def get_data_class(cls, name: str):
        return cls.mapping["data_name_mapping"].get(name, None)

    @classmethod
    def list_models(cls) -> list[str]:
        return sorted(cls.mapping["model_name_mapping"])

    @classmethod
    def list_datasets(cls) -> list[str]:
        return sorted(cls.mapping["data_name_mapping"])


registry = Registry()
