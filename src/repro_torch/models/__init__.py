"""Dense GQA transformer, serving subset (torch port of ``repro.models``)."""
