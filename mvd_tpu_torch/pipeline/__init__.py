from .pipeline import MVDPipeline, build_schedule  # noqa: F401
