from deequ_tpu_torch.verification.suite import (
    VerificationResult,
    VerificationRunBuilder,
    VerificationSuite,
)

__all__ = ["VerificationResult", "VerificationRunBuilder", "VerificationSuite"]
