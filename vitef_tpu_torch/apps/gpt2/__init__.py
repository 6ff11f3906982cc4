"""GPT-2 serving apps: ``sample`` (one prompt) and ``serve`` (a request stream)."""
