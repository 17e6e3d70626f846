"""What the in-transit ``TensorNormReducer`` writes to HDep, computed
plainly: (l2, rms, absmax, mean) of every matrix leaf of the parameters.

``expect(params)`` gives the table from a {dotted path: tensor} state,
``table(output)`` reads it from the reducer's output as the catalog
returns it, and ``gap(prog, ref)`` is the number compared."""
from portbench import yardstick

gap = yardstick.stats_gap


def expect(params: dict) -> dict:
    return {p: yardstick.tensor_stats(x) for p, x in params.items()
            if x.ndim >= 2}


def table(output) -> dict:
    return {str(n): [float(v) for v in row]
            for n, row in zip(output["names"], output["stats"])}
