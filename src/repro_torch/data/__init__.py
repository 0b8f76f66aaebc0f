from .pipeline import PipelineState, TokenPipeline

__all__ = ["TokenPipeline", "PipelineState"]
