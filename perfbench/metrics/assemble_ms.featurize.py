"""assemble_ms.featurize: the host's chunk assembly, ms a chunk: the
busy seconds of the HostPipeline's "assemble" stage (TorchModel.run_grouped
stacking a chunk's rows) over the chunks it assembled in the window."""
NAME = "assemble_ms.featurize"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "chunk assembly"
MOVES = "images_per_s"


def read(view):
    stage = view.counters.get("pipeline", {}).get("assemble", {})
    if not stage.get("items"):
        return None
    return stage["busy_s"] / stage["items"] * 1e3
