from .pipeline import (IngestDocument, IngestService, Pipeline, Processor,
                       build_processor, register_processor)

__all__ = ["IngestDocument", "IngestService", "Pipeline", "Processor",
           "build_processor", "register_processor"]
