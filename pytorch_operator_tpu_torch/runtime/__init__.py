"""Device resolution and the worker side of the supervisor's status channel."""
