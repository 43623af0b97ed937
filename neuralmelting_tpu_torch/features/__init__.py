from neuralmelting_tpu_torch.features.rdf import (  # noqa: F401
    rdf_hist, rdf_frames, structure_factor, density)
