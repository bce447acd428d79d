"""Scala-style ``Try`` values: failures are data, not control flow.

The reference wraps every metric value in ``Try[Value]`` so a failed
analyzer (missing column, empty state, cast error) produces a *failure
metric* and the run still completes (reference:
``src/main/scala/com/amazon/deequ/metrics/Metric.scala``; SURVEY.md §2.1,
§5.3). This module is the Python equivalent used throughout deequ_tpu_torch.
"""

from __future__ import annotations

from typing import Callable, Generic, TypeVar

T = TypeVar("T")
U = TypeVar("U")


class Try(Generic[T]):
    """Either a ``Success(value)`` or a ``Failure(exception)``."""

    @property
    def is_success(self) -> bool:
        raise NotImplementedError

    @property
    def is_failure(self) -> bool:
        return not self.is_success

    def get(self) -> T:
        raise NotImplementedError

    def get_or_else(self, default: U) -> T | U:
        return self.get() if self.is_success else default

    @property
    def exception(self) -> BaseException | None:
        return None

    def map(self, fn: Callable[[T], U]) -> "Try[U]":
        raise NotImplementedError

    def recover(self, fn: Callable[[BaseException], U]) -> "Try[T | U]":
        """Scala's ``Try.recover``: a Success passes through; a Failure
        becomes ``Try.of(lambda: fn(exception))`` — so a raising
        recovery function is itself a Failure, never an escape."""
        raise NotImplementedError

    @staticmethod
    def of(fn: Callable[[], T]) -> "Try[T]":
        try:
            return Success(fn())
        except Exception as exc:  # noqa: BLE001 — failures-as-values by design
            return Failure(exc)

    @staticmethod
    def of_retry(fn: Callable[[], T], attempts: int) -> "Try[T]":
        """``Try.of`` with up to ``attempts`` total tries: re-run ``fn``
        on any Exception until one succeeds or the budget is spent, then
        carry the LAST failure. No backoff — callers that need delays
        use the engine's RetryPolicy; this is the value-level analog for
        cheap idempotent thunks (repository reads, metric recompute)."""
        result: Try[T] = Failure(
            ValueError(f"of_retry needs attempts >= 1, got {attempts}")
        )
        for _ in range(max(int(attempts), 0)):
            result = Try.of(fn)
            if result.is_success:
                return result
        return result


class Success(Try[T]):
    __slots__ = ("_value",)

    def __init__(self, value: T):
        self._value = value

    @property
    def is_success(self) -> bool:
        return True

    def get(self) -> T:
        return self._value

    def map(self, fn: Callable[[T], U]) -> Try[U]:
        return Try.of(lambda: fn(self._value))

    def recover(self, fn: Callable[[BaseException], U]) -> Try[T]:
        return self

    def __repr__(self) -> str:
        return f"Success({self._value!r})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Success) and other._value == self._value

    def __hash__(self) -> int:
        return hash(("Success", self._value))


class Failure(Try[T]):
    __slots__ = ("_exception",)

    def __init__(self, exception: BaseException):
        self._exception = exception

    @property
    def is_success(self) -> bool:
        return False

    def get(self) -> T:
        raise self._exception

    @property
    def exception(self) -> BaseException:
        return self._exception

    def map(self, fn: Callable[[T], U]) -> Try[U]:
        return Failure(self._exception)

    def recover(self, fn: Callable[[BaseException], U]) -> Try[U]:
        return Try.of(lambda: fn(self._exception))

    def __repr__(self) -> str:
        return f"Failure({self._exception!r})"

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Failure)
            and type(other._exception) is type(self._exception)
            and str(other._exception) == str(self._exception)
        )

    def __hash__(self) -> int:
        return hash(("Failure", type(self._exception), str(self._exception)))
