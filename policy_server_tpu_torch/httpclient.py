"""The outbound HTTP client: one small GET client on ``http.client`` and
``ssl``, shared by the policy downloader (``fetch/downloader.py``) and the
Kubernetes API client (``context/service.py``).

It does for these two callers what the JAX package gets from
``requests``:

* **TLS per request.** ``verify`` is ``True`` (the system trust store),
  ``False`` (no verification: only for a source the operator listed as
  insecure, or ``--kube-insecure-skip-tls-verify``), or the path of a CA
  bundle, which is then the only trust anchor. ``cadata`` gives the
  bundle as PEM text instead.
* **Timeouts.** ``timeout`` bounds the connect and every read; a
  ``(connect, read)`` pair bounds them apart, so a quiet but healthy
  watch stream lives as long as its read timeout allows.
* **Redirects.** Up to 30 are followed, as ``requests`` does. A redirect
  that leaves the host drops ``Authorization`` (``requests``'
  ``should_strip_auth`` rule): registries answer blob GETs with a 307 to
  object storage, and the registry's credentials must not travel there
  (a presigned URL refuses a request that carries them). A redirect to
  another host takes its TLS context from ``context_for``.
* **Streams.** ``stream=True`` leaves the body unread; ``iter_lines()``
  yields each line as it arrives (chunked or not), returns at a clean
  close, and raises :class:`RequestError` when the transport fails.

No proxy variable is honoured. :class:`RequestError` is every transport
failure (connect, TLS, timeout, a truncated body); :class:`HTTPError`,
raised by :meth:`Response.raise_for_status`, carries the response."""

from __future__ import annotations

import http.client
import json
import ssl
import urllib.parse
from typing import Any, Callable, Iterator, Mapping

MAX_REDIRECTS = 30
_REDIRECT_STATUSES = frozenset({301, 302, 303, 307, 308})
_DEFAULT_PORTS = {"http": 80, "https": 443}


class RequestError(OSError):
    """A request that got no HTTP answer: connect, TLS, timeout, a
    truncated body or too many redirects."""


class HTTPError(RequestError):
    """A non-2xx answer, raised by :meth:`Response.raise_for_status`."""

    def __init__(self, message: str, response: "Response | None" = None):
        super().__init__(message)
        self.response = response


class Response:
    """One answer: ``status_code``, case-insensitive ``headers``, the
    final ``url``, and the body as ``content`` (read at once) or, with
    ``stream=True``, through :meth:`iter_lines`."""

    def __init__(
        self, url: str, conn: http.client.HTTPConnection,
        raw: http.client.HTTPResponse, stream: bool,
    ) -> None:
        self.url = url
        self.status_code = raw.status
        self.reason = raw.reason
        self.headers = raw.headers
        self._conn = conn
        self._raw = raw
        self._content: bytes | None = None
        if not stream:
            try:
                self._content = raw.read()
            except (OSError, http.client.HTTPException) as e:
                raise RequestError(f"GET {url}: reading the body failed: {e}") from e
            finally:
                self.close()

    @property
    def content(self) -> bytes:
        if self._content is None:
            try:
                self._content = self._raw.read()
            except (OSError, http.client.HTTPException) as e:
                raise RequestError(
                    f"GET {self.url}: reading the body failed: {e}"
                ) from e
            finally:
                self.close()
        return self._content

    def json(self) -> Any:
        return json.loads(self.content)

    def raise_for_status(self) -> None:
        if not 200 <= self.status_code < 300:
            raise HTTPError(
                f"{self.status_code} {self.reason} for url: {self.url}",
                response=self,
            )

    def iter_lines(self) -> Iterator[bytes]:
        """Each line of a streamed body as it arrives, without its line
        end. Returns when the server ends the body cleanly; raises
        :class:`RequestError` when the transport fails mid-stream (a
        reset, a read timeout, a chunked body cut short)."""
        try:
            while True:
                try:
                    line = self._raw.readline()
                except (OSError, http.client.HTTPException, ValueError) as e:
                    raise RequestError(
                        f"GET {self.url}: stream failed: {e}"
                    ) from e
                if not line:
                    return
                yield line.rstrip(b"\r\n")
        finally:
            self.close()

    def close(self) -> None:
        self._raw.close()
        self._conn.close()

    def __enter__(self) -> "Response":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def ssl_context(verify: Any = True, cadata: str | None = None) -> ssl.SSLContext:
    """The client context for one request: no verification for
    ``verify=False``, the given bundle (only) for a path or ``cadata``,
    else the system trust store."""
    if verify is False:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return ctx
    if cadata is not None:
        return ssl.create_default_context(cadata=cadata)
    if isinstance(verify, str):
        return ssl.create_default_context(cafile=verify)
    return ssl.create_default_context()


def should_strip_auth(old_url: str, new_url: str) -> bool:
    """``requests``' rule: a redirect to another host, port or scheme
    drops ``Authorization``, except an http → https upgrade on the
    default ports of one host."""
    old, new = urllib.parse.urlsplit(old_url), urllib.parse.urlsplit(new_url)
    if old.hostname != new.hostname:
        return True
    if (
        old.scheme == "http" and old.port in (80, None)
        and new.scheme == "https" and new.port in (443, None)
    ):
        return False
    changed_port = old.port != new.port
    changed_scheme = old.scheme != new.scheme
    default_port = (_DEFAULT_PORTS.get(old.scheme), None)
    if (
        not changed_scheme
        and old.port in default_port
        and new.port in default_port
    ):
        return False
    return changed_port or changed_scheme


def _timeouts(timeout: Any) -> tuple[float | None, float | None]:
    if isinstance(timeout, (tuple, list)):
        return timeout[0], timeout[1]
    return timeout, timeout


def _open(
    url: str, headers: Mapping[str, str], timeout: Any,
    context: ssl.SSLContext | None, stream: bool,
) -> Response:
    parts = urllib.parse.urlsplit(url)
    connect_timeout, read_timeout = _timeouts(timeout)
    host = parts.hostname or ""
    target = parts.path or "/"
    if parts.query:
        target += "?" + parts.query
    try:
        if parts.scheme == "https":
            conn: http.client.HTTPConnection = http.client.HTTPSConnection(
                host, parts.port, timeout=connect_timeout,
                context=context or ssl_context(),
            )
        elif parts.scheme == "http":
            conn = http.client.HTTPConnection(
                host, parts.port, timeout=connect_timeout
            )
        else:
            raise RequestError(f"unsupported URL scheme: {url}")
    except ValueError as e:  # a malformed port
        raise RequestError(f"GET {url}: {e}") from e
    try:
        conn.connect()
        if conn.sock is not None:
            conn.sock.settimeout(read_timeout)
        conn.putrequest("GET", target, skip_accept_encoding=True)
        sent = {k.lower() for k in headers}
        if "user-agent" not in sent:
            conn.putheader("User-Agent", "kubewarden-policy-server")
        if "accept" not in sent:
            conn.putheader("Accept", "*/*")
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.endheaders()
        raw = conn.getresponse()
    except (OSError, http.client.HTTPException) as e:
        conn.close()
        if isinstance(e, RequestError):
            raise
        raise RequestError(f"GET {url} failed: {e}") from e
    return Response(url, conn, raw, stream)


def get(
    url: str,
    *,
    params: Mapping[str, str] | None = None,
    headers: Mapping[str, str] | None = None,
    timeout: Any = 30,
    verify: Any = True,
    cadata: str | None = None,
    context_for: Callable[[str], ssl.SSLContext] | None = None,
    stream: bool = False,
) -> Response:
    """GET ``url`` (``params`` appended to its query), following
    redirects. ``verify``/``cadata`` set the TLS trust of the first host
    and of redirects that stay on it; ``context_for(netloc)`` gives the
    context of a redirect to another host (the system store when not
    given)."""
    if params:
        parts = urllib.parse.urlsplit(url)
        query = urllib.parse.urlencode(list(params.items()))
        url = urllib.parse.urlunsplit(parts._replace(
            query=f"{parts.query}&{query}" if parts.query else query
        ))
    headers = dict(headers or {})
    first_netloc = urllib.parse.urlsplit(url).netloc
    for _ in range(MAX_REDIRECTS + 1):
        netloc = urllib.parse.urlsplit(url).netloc
        if netloc == first_netloc:
            context = ssl_context(verify, cadata)
        else:
            context = (
                context_for(netloc) if context_for is not None
                else ssl_context()
            )
        resp = _open(url, headers, timeout, context, stream)
        location = resp.headers.get("Location")
        if resp.status_code not in _REDIRECT_STATUSES or not location:
            return resp
        resp.close()
        new_url = urllib.parse.urljoin(url, location)
        if should_strip_auth(url, new_url):
            headers = {
                k: v for k, v in headers.items()
                if k.lower() != "authorization"
            }
        url = new_url
    raise RequestError(f"exceeded {MAX_REDIRECTS} redirects")

