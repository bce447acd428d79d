"""SQL predicates for Compliance and ``where=`` filters."""

from deequ_tpu_torch.sql.predicate import (
    CompiledPredicate,
    PredicateParseError,
    compile_predicate,
    parse_predicate,
)

__all__ = [
    "CompiledPredicate",
    "PredicateParseError",
    "compile_predicate",
    "parse_predicate",
]
