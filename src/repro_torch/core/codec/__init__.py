"""repro_torch.core.codec: the composable codec pipeline of the port (port
of repro/core/codec).

    from repro_torch.core import codec
    pipe = codec.Pipeline([
        codec.RandProjSpatial(k=64, d_block=1024, transform="avg"),
        codec.Int8Quant(),
        codec.ErrorFeedback(),
    ])
    payload, state = pipe.encode(seed, client_id, x_chunks, state=state)
    x_hat = pipe.decode(seed, stacked_payloads, n)

Payloads are self-describing (budgets and the declared byte ledger ride in
``payload.meta``); client-held cross-round state (EF residuals, temporal
memories) lives in an explicit ``ClientState``. ``build(name, **kwargs)``
keeps the flat-keyword construction style.
"""
from .budget import (  # noqa: F401
    BudgetExceedsDimension,
    adaptive_chunk_budgets,
    jl_min_k,
    suggest_budget,
)
from .compat import as_pipeline, build  # noqa: F401
from .entropy import EntropyCode, coded_payload_nbytes  # noqa: F401
from .payload import (  # noqa: F401
    AUX,
    INDICES,
    SCALES,
    VALUES,
    ArraySpec,
    Payload,
    PayloadMeta,
    check_against_schema,
    with_staleness,
)
from .pipeline import Pipeline  # noqa: F401
from .quantizers import (  # noqa: F401
    QUANTIZERS,
    Bf16Quant,
    CorrelatedQuant,
    Int8Quant,
)
from .sparsifiers import (  # noqa: F401
    SPARSIFIERS,
    Identity,
    Induced,
    RandK,
    RandKSpatial,
    RandProjSpatial,
    Sparsifier,
    SparseProj,
    TopK,
    Wangni,
)
from .stages import ClientState, ErrorFeedback, Temporal  # noqa: F401
