from .from_jax import convert_jax_params, load_jax_params, load_jax_train_state  # noqa: F401
