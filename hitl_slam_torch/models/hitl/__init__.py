"""Human-in-the-Loop map repair: the correction cycle and its engine."""
