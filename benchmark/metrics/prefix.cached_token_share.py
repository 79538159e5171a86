"""prefix.cached_token_share: the share, in percent, of the window's prompt
tokens that the prefix cache served (each request's `cached_tokens`) and
so were not prefilled."""

from benchmark.harness.readers import sent_in_window


def read(run):
    recs = [r for r in sent_in_window(run) if r.first is not None]
    prompt = sum(len(r.prompt) for r in recs)
    return 100.0 * sum(r.cached for r in recs) / prompt if prompt else None
