"""Minimal Python client for the REST API.

Reference: the generated go-swagger client (client/, 34k lines) used by
the acceptance tests — this is the hand-rolled equivalent for ours.
"""

from __future__ import annotations

import http.client
import json
import urllib.parse


class RestError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status


class Client:
    def __init__(self, addr: str, timeout: float = 30.0):
        self.addr = addr
        self.timeout = timeout

    def request(self, method: str, path: str, params: dict | None = None,
                body=None):
        host, _, port = self.addr.partition(":")
        if params:
            path = path + "?" + urllib.parse.urlencode(
                {k: v for k, v in params.items() if v is not None})
        conn = http.client.HTTPConnection(host, int(port),
                                          timeout=self.timeout)
        try:
            conn.request(method, path,
                         body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        payload = json.loads(raw) if raw else None
        if resp.status >= 400:
            msg = ""
            if isinstance(payload, dict) and payload.get("error"):
                msg = payload["error"][0].get("message", "")
            raise RestError(resp.status, msg)
        return payload

    # -- meta -----------------------------------------------------------------

    def meta(self) -> dict:
        return self.request("GET", "/v1/meta")

    def ready(self) -> bool:
        try:
            self.request("GET", "/.well-known/ready")
            return True
        except (RestError, OSError):
            return False

    def nodes(self) -> list[dict]:
        return self.request("GET", "/v1/nodes")["nodes"]

    # -- schema ---------------------------------------------------------------

    def create_class(self, config: dict) -> dict:
        return self.request("POST", "/v1/schema", body=config)

    def get_schema(self) -> dict:
        return self.request("GET", "/v1/schema")

    def get_class(self, name: str) -> dict:
        return self.request("GET", f"/v1/schema/{name}")

    def delete_class(self, name: str) -> None:
        self.request("DELETE", f"/v1/schema/{name}")

    def add_property(self, class_name: str, prop: dict) -> dict:
        return self.request("POST", f"/v1/schema/{class_name}/properties",
                            body=prop)

    def add_tenants(self, class_name: str, tenants: list[str]):
        return self.request("POST", f"/v1/schema/{class_name}/tenants",
                            body=[{"name": t} for t in tenants])

    def get_tenants(self, class_name: str) -> list[dict]:
        return self.request("GET", f"/v1/schema/{class_name}/tenants")

    # -- objects --------------------------------------------------------------

    def create_object(self, class_name: str, properties: dict, vector=None,
                      uuid: str | None = None, tenant: str | None = None) -> dict:
        body = {"class": class_name, "properties": properties}
        if vector is not None:
            body["vector"] = list(vector)
        if uuid is not None:
            body["id"] = uuid
        return self.request("POST", "/v1/objects",
                            params={"tenant": tenant} if tenant else None,
                            body=body)

    def get_object(self, class_name: str, uuid: str,
                   tenant: str | None = None,
                   consistency_level: str | None = None) -> dict:
        return self.request("GET", f"/v1/objects/{class_name}/{uuid}",
                            params={"tenant": tenant,
                                    "consistency_level": consistency_level})

    def delete_object(self, class_name: str, uuid: str,
                      tenant: str | None = None) -> None:
        self.request("DELETE", f"/v1/objects/{class_name}/{uuid}",
                     params={"tenant": tenant} if tenant else None)

    def patch_object(self, class_name: str, uuid: str, properties: dict) -> dict:
        return self.request("PATCH", f"/v1/objects/{class_name}/{uuid}",
                            body={"properties": properties})

    def list_objects(self, class_name: str, limit: int = 25, offset: int = 0,
                     after: str | None = None, sort: str | None = None,
                     order: str | None = None, where: dict | None = None,
                     tenant: str | None = None) -> dict:
        return self.request("GET", "/v1/objects", params={
            "class": class_name, "limit": limit, "offset": offset,
            "after": after, "sort": sort, "order": order,
            "where": json.dumps(where) if where else None, "tenant": tenant})

    def batch_objects(self, objects: list[dict]) -> list[dict]:
        return self.request("POST", "/v1/batch/objects",
                            body={"objects": objects})

    # -- graphql --------------------------------------------------------------

    def graphql(self, query: str, variables: dict | None = None) -> dict:
        return self.request("POST", "/v1/graphql",
                            body={"query": query,
                                  "variables": variables or {}})
