"""CUDA graphs captured during the window call
(``train_metrics["graph_captures"]``): 0 where nothing compiles in the
measured window."""


def read(ctx):
    train = ctx.get("train")
    if not train or "graph_captures" not in train:
        return None
    return float(train["graph_captures"])
