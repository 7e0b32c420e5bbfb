"""Runtime services: failure detection for the churn schedules."""
