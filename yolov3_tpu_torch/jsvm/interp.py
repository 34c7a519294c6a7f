"""Tree-walking interpreter for the ES subset of js/src (see jsvm/lexer.py).

Design notes:
  * Values map to Python: JS number → float (ints appear transiently from
    host shims and behave identically), string → str, boolean → bool,
    null/undefined → None, array → Python list, object literal → dict,
    function → JSFunction (Python-callable so host shims can invoke JS
    callbacks directly, e.g. ``tf.tidy(fn)``).
  * Host objects (the TFJS shim, canvas/image stand-ins) are bridged by
    attribute access; host callables are called positionally.
  * async/await run synchronously: an async function returns
    ``JSPromise(value)``; ``await`` unwraps. ``Promise.all`` maps+unwraps.
    This matches the browser port's usage: every await there resolves
    at once, since the shim's tensor math is synchronous.
  * Modules execute once and are cached; ``import {a} from "./x.js"``
    resolves relative to the importing file like a browser module graph.

Framework-neutral copy of ``yolov3_tpu/jsvm/interp.py`` (the standard library
only; the port imports nothing of the JAX package). tests/test_torch_jsvm.py
pins its code, everything after this docstring, to its original.
"""

from __future__ import annotations

import functools
import math
import os

from .lexer import JsSyntaxError
from .parser import parse, parse_expr

__all__ = ["Interpreter", "JSFunction", "JSPromise", "JsError", "JsThrow",
           "js_truthy", "js_to_string", "JsSyntaxError"]


class JsError(Exception):
    """Interpreter-level error (TypeError/ReferenceError equivalents)."""


class JsThrow(Exception):
    """A JS ``throw`` in flight; ``value`` is the thrown JS value."""

    def __init__(self, value):
        super().__init__(js_to_string(value))
        self.value = value


class _Control(Exception):
    pass


class _Return(_Control):
    def __init__(self, value):
        self.value = value


class _Break(_Control):
    pass


class _Continue(_Control):
    pass


class JSPromise:
    """Already-settled promise — the only kind this synchronous runtime has."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def then(self, on_fulfilled=None, _on_rejected=None):
        if on_fulfilled is None:
            return self
        return JSPromise(_unwrap(on_fulfilled(self.value)))


def _unwrap(v):
    while isinstance(v, JSPromise):
        v = v.value
    return v


class Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None, vars=None):
        self.vars = vars if vars is not None else {}
        self.parent = parent

    def lookup(self, name):
        env = self
        while env is not None:
            if name in env.vars:
                return env.vars[name]
            env = env.parent
        raise JsError(f"{name} is not defined")

    def assign(self, name, value):
        env = self
        while env is not None:
            if name in env.vars:
                env.vars[name] = value
                return
            env = env.parent
        raise JsError(f"assignment to undeclared variable {name}")

    def declare(self, name, value):
        self.vars[name] = value


class JSFunction:
    def __init__(self, interp, params, body, env, name=None,
                 is_async=False, expr_body=False):
        self.interp = interp
        self.params = params
        self.body = body
        self.env = env
        self.name = name or "<anonymous>"
        self.is_async = is_async
        self.expr_body = expr_body

    def __call__(self, *args):
        env = Env(parent=self.env)
        self.interp.bind_params(self.params, list(args), env)
        try:
            if self.expr_body:
                result = self.interp.eval(self.body, env)
            else:
                self.interp.exec_block(self.body, env)
                result = None
        except _Return as r:
            result = r.value
        if self.is_async:
            return JSPromise(_unwrap(result))
        return result

    def __repr__(self):  # pragma: no cover
        return f"<JSFunction {self.name}>"


def js_truthy(v) -> bool:
    if v is None or v is False:
        return False
    if v is True:
        return True
    if isinstance(v, (int, float)):
        return not (v == 0 or (isinstance(v, float) and math.isnan(v)))
    if isinstance(v, str):
        return len(v) > 0
    return True  # objects/arrays/functions: always truthy (even when empty)


def js_to_string(v) -> str:
    if v is None:
        return "undefined"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, (int, float)):
        return _num_to_string(float(v))
    if isinstance(v, str):
        return v
    if isinstance(v, list):
        return ",".join("" if x is None else js_to_string(x) for x in v)
    if isinstance(v, dict):
        return "[object Object]"
    return str(v)


def _num_to_string(x: float) -> str:
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    if x == int(x) and abs(x) < 1e21:
        return str(int(x))
    return repr(x)


def _to_int32(x) -> float:
    f = float(x)
    if math.isnan(f) or math.isinf(f):
        return 0.0  # ECMA ToInt32
    n = int(f) & 0xFFFFFFFF
    if n >= 0x80000000:
        n -= 0x100000000
    return float(n)


def _strict_eq(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return float(a) == float(b)
    if type(a) is type(b) or (isinstance(a, str) and isinstance(b, str)):
        if isinstance(a, (list, dict)):
            return a is b
        return a == b
    return a is b


def _js_tofixed(x: float, digits: float) -> str:
    # ECMA-262 Number.prototype.toFixed: nearest, ties away from larger n
    d = int(digits)
    neg = x < 0 or (x == 0 and math.copysign(1, x) < 0)
    ax = abs(float(x))
    scaled = ax * (10 ** d)
    n = math.floor(scaled)
    if scaled - n >= 0.5:
        n += 1
    s = str(n)
    if d:
        s = s.rjust(d + 1, "0")
        s = s[:-d] + "." + s[-d:]
    return ("-" if neg and n != 0 else "") + s


def _cmp_sign(v) -> int:
    v = float(v)
    if v < 0:
        return -1
    if v > 0:
        return 1
    return 0


# ---------------------------------------------------------------------------
# built-in member dispatch for primitive values


def _array_members(interp, lst: list, name: str):
    if name == "length":
        return float(len(lst))
    if name == "push":
        def push(*items):
            lst.extend(items)
            return float(len(lst))
        return push
    if name == "pop":
        return lambda: lst.pop() if lst else None
    if name == "forEach":
        def for_each(cb):
            for i, v in enumerate(lst):
                cb(v, float(i), lst)
            return None
        return for_each
    if name == "map":
        return lambda cb: [cb(v, float(i), lst) for i, v in enumerate(lst)]
    if name == "filter":
        return lambda cb: [v for i, v in enumerate(lst)
                           if js_truthy(cb(v, float(i), lst))]
    if name == "slice":
        def arr_slice(start=None, end=None):
            s = 0 if start is None else int(start)
            e = len(lst) if end is None else int(end)
            return list(lst[slice(*_norm_range(len(lst), s, e))])
        return arr_slice
    if name == "concat":
        def arr_concat(*others):
            out = list(lst)
            for o in others:
                out.extend(o) if isinstance(o, list) else out.append(o)
            return out
        return arr_concat
    if name == "indexOf":
        def index_of(v):
            for i, x in enumerate(lst):
                if _strict_eq(x, v):
                    return float(i)
            return -1.0
        return index_of
    if name == "includes":
        return lambda v: any(_strict_eq(x, v) for x in lst)
    if name == "join":
        return lambda sep=",": (sep if sep is not None else ",").join(
            "" if x is None else js_to_string(x) for x in lst)
    if name == "sort":
        def sort(cmp=None):
            if cmp is None:
                lst.sort(key=js_to_string)
            else:
                lst.sort(key=functools.cmp_to_key(
                    lambda a, b: _cmp_sign(cmp(a, b))))
            return lst
        return sort
    if name == "reduce":
        def reduce(cb, *init):
            it = iter(enumerate(lst))
            if init:
                acc = init[0]
            else:
                _, acc = next(it)
            for i, v in it:
                acc = cb(acc, v, float(i), lst)
            return acc
        return reduce
    if name == "flat":
        def flat(depth=1.0):
            def go(xs, d):
                out = []
                for x in xs:
                    if isinstance(x, list) and d > 0:
                        out.extend(go(x, d - 1))
                    else:
                        out.append(x)
                return out
            return go(lst, int(depth))
        return flat
    raise JsError(f"array has no member {name!r}")


def _norm_range(n, s, e):
    if s < 0:
        s = max(0, n + s)
    if e < 0:
        e = max(0, n + e)
    return min(s, n), min(e, n)


def _string_members(s: str, name: str):
    if name == "length":
        return float(len(s))
    if name == "charCodeAt":
        return lambda i=0.0: float(ord(s[int(i)])) if 0 <= int(i) < len(s) else float("nan")
    if name == "charAt":
        return lambda i=0.0: s[int(i)] if 0 <= int(i) < len(s) else ""
    if name == "slice":
        return lambda a=0.0, b=None: s[slice(*_norm_range(
            len(s), int(a), len(s) if b is None else int(b)))]
    if name == "toUpperCase":
        return lambda: s.upper()
    if name == "toLowerCase":
        return lambda: s.lower()
    if name == "includes":
        return lambda sub: sub in s
    if name == "split":
        return lambda sep=None: list(s) if sep == "" else s.split(sep)
    if name == "indexOf":
        return lambda sub: float(s.find(sub))
    if name == "padStart":
        return lambda width, fill=" ": s.rjust(int(width), fill)
    if name == "toFixed":
        raise JsError("toFixed called on a string")
    raise JsError(f"string has no member {name!r}")


def _number_members(x: float, name: str):
    if name == "toFixed":
        return lambda digits=0.0: _js_tofixed(float(x), digits)
    if name == "toString":
        return lambda: _num_to_string(float(x))
    raise JsError(f"number has no member {name!r}")


def _make_math():
    return {
        "imul": lambda a, b: _to_int32(_to_int32(a) * _to_int32(b)),
        "abs": lambda x: float(abs(float(x))),
        "max": lambda *xs: float(max(float(x) for x in xs)) if xs else float("-inf"),
        "min": lambda *xs: float(min(float(x) for x in xs)) if xs else float("inf"),
        "floor": lambda x: float(math.floor(float(x))),
        "ceil": lambda x: float(math.ceil(float(x))),
        "round": lambda x: float(math.floor(float(x) + 0.5)),
        "sqrt": lambda x: float(math.sqrt(float(x))),
        "exp": lambda x: float(math.exp(float(x))),
        "log": lambda x: float(math.log(float(x))),
        "pow": lambda a, b: float(float(a) ** float(b)),
        "sign": lambda x: float(_cmp_sign(x)),
        "PI": math.pi,
        "E": math.e,
        "trunc": lambda x: float(math.trunc(float(x))),
    }


def _make_globals():
    return {
        "Math": _make_math(),
        "Array": {"isArray": lambda v=None: isinstance(v, list),
                  "from": lambda v: list(v)},
        "Object": {"keys": lambda o: list(o.keys()) if isinstance(o, dict) else [],
                   "values": lambda o: list(o.values()) if isinstance(o, dict) else [],
                   "entries": lambda o: [[k, v] for k, v in o.items()]
                   if isinstance(o, dict) else []},
        "Promise": {"all": lambda ps: JSPromise([_unwrap(p) for p in ps]),
                    "resolve": lambda v=None: JSPromise(_unwrap(v))},
        "Number": {"isFinite": lambda v=None: isinstance(v, (int, float))
                   and math.isfinite(float(v)),
                   "isInteger": lambda v=None: isinstance(v, (int, float))
                   and float(v).is_integer()},
        "JSON": {"stringify": lambda v, *_: _json_stringify(v)},
        "console": {"log": lambda *args: print(*[js_to_string(a) for a in args]),
                    "warn": lambda *args: print(*[js_to_string(a) for a in args]),
                    "error": lambda *args: print(*[js_to_string(a) for a in args])},
        "NaN": float("nan"),
        "Infinity": float("inf"),
        "parseInt": _js_parse_int,
        "parseFloat": _js_parse_float,
        "isNaN": lambda v: isinstance(v, float) and math.isnan(v),
        "String": js_to_string,
    }


def _js_parse_int(s, base=10.0):
    """ECMA parseInt: longest valid prefix of ToString(s); NaN if none."""
    text = js_to_string(s).strip()
    b = int(base) if base and not math.isnan(float(base)) else 10
    sign = 1
    if text[:1] in "+-":
        sign = -1 if text[0] == "-" else 1
        text = text[1:]
    if b == 16 and text[:2].lower() == "0x":
        text = text[2:]
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:b]
    i = 0
    while i < len(text) and text[i].lower() in digits:
        i += 1
    if i == 0:
        return float("nan")
    return float(sign * int(text[:i], b))


def _js_parse_float(s):
    """ECMA parseFloat: longest valid decimal prefix; NaN if none."""
    import re

    text = js_to_string(s).strip()
    m = re.match(r"[+-]?(Infinity|\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)",
                 text)
    if not m:
        return float("nan")
    token = m.group(0)
    return float("inf") * (-1 if token.startswith("-") else 1) \
        if token.lstrip("+-") == "Infinity" else float(token)


def _json_stringify(v):
    import json

    def conv(x):
        if isinstance(x, float) and x.is_integer():
            return int(x)
        if isinstance(x, list):
            return [conv(i) for i in x]
        if isinstance(x, dict):
            return {k: conv(val) for k, val in x.items()}
        return x

    return json.dumps(conv(v))


class Interpreter:
    """Executes parsed js/src modules against host-provided globals."""

    def __init__(self, globals_extra: dict | None = None):
        g = _make_globals()
        if globals_extra:
            g.update(globals_extra)
        self.global_env = Env(vars=g)
        self.modules: dict[str, dict] = {}

    # ---- public API ----------------------------------------------------
    def load_module(self, path: str) -> dict:
        """Execute an ES module file; returns its exports dict (cached)."""
        path = os.path.realpath(path)
        if path in self.modules:
            return self.modules[path]
        with open(path) as f:
            src = f.read()
        program = parse(src)
        env = Env(parent=self.global_env)
        exports: dict = {}
        self.modules[path] = exports  # pre-register (cycle tolerance)
        self._hoist_functions(program[1], env)
        for stmt in program[1]:
            self.exec_stmt(stmt, env, exports=exports, module_dir=os.path.dirname(path))
        # ES module bindings are live: re-read each exported name after the
        # module body finishes (a module may mutate its own exported lets)
        for name in list(exports):
            exports[name] = env.lookup(name)
        return exports

    def run(self, src: str, env: Env | None = None):
        """Run a script string; returns the value of the last expression."""
        program = parse(src)
        env = env or Env(parent=self.global_env)
        self._hoist_functions(program[1], env)
        result = None
        for stmt in program[1]:
            if stmt[0] == "expr":
                result = self.eval(stmt[1], env)
            else:
                self.exec_stmt(stmt, env)
                result = None
        return result

    def eval_expr(self, src: str, env: Env | None = None):
        return self.eval(parse_expr(src), env or Env(parent=self.global_env))

    @staticmethod
    def call(fn, *args):
        """Call a JS function from the host, unwrapping any promise."""
        return _unwrap(fn(*args))

    # ---- statements ----------------------------------------------------
    def _hoist_functions(self, stmts, env):
        for stmt in stmts:
            if stmt[0] == "func" and stmt[5]:
                self._declare_function(stmt, env)
            elif stmt[0] == "export" and stmt[1][0] == "func" and stmt[1][5]:
                self._declare_function(stmt[1], env)

    def _declare_function(self, node, env):
        _, name, params, body, is_async, _ = node
        fn = JSFunction(self, params, body, env, name=name, is_async=is_async)
        env.declare(name, fn)
        return name, fn

    def exec_block(self, block, env):
        stmts = block[1]
        self._hoist_functions(stmts, env)
        for stmt in stmts:
            self.exec_stmt(stmt, env)

    def exec_stmt(self, stmt, env, exports=None, module_dir=None):
        kind = stmt[0]
        if kind == "expr":
            self.eval(stmt[1], env)
        elif kind == "decl":
            for target, init in stmt[2]:
                value = self.eval(init, env) if init is not None else None
                self.bind_pattern(target, value, env)
        elif kind == "func":
            if stmt[5] and stmt[1] not in env.vars:
                self._declare_function(stmt, env)
        elif kind == "return":
            raise _Return(self.eval(stmt[1], env) if stmt[1] is not None else None)
        elif kind == "if":
            if js_truthy(self.eval(stmt[1], env)):
                self.exec_stmt(stmt[2], Env(parent=env))
            elif stmt[3] is not None:
                self.exec_stmt(stmt[3], Env(parent=env))
        elif kind == "block":
            self.exec_block(stmt, Env(parent=env))
        elif kind == "for":
            init, test, update, body = stmt[1], stmt[2], stmt[3], stmt[4]
            loop_env = Env(parent=env)
            if init is not None:
                self.exec_stmt(init, loop_env)
            # ES2020: let/const loop variables get a FRESH binding each
            # iteration (closures created in the body capture that
            # iteration's value, not the final one)
            per_iter = []
            if init is not None and init[0] == "decl" and init[1] in ("let", "const"):
                per_iter = [n for target, _ in init[2]
                            for n in _pattern_names(target)]
            while test is None or js_truthy(self.eval(test, loop_env)):
                if per_iter:
                    iter_env = Env(parent=env)
                    for n in per_iter:
                        iter_env.declare(n, loop_env.vars[n])
                else:
                    iter_env = loop_env
                try:
                    self.exec_stmt(body, Env(parent=iter_env))
                except _Break:
                    break
                except _Continue:
                    pass
                if per_iter:  # body mutations flow into the update/test copy
                    for n in per_iter:
                        loop_env.vars[n] = iter_env.vars[n]
                if update is not None:
                    self.eval(update, loop_env)
        elif kind == "forof":
            decl, iterable, body = stmt[1], stmt[2], stmt[3]
            seq = self.eval(iterable, env)
            if seq is None:
                raise JsError("for..of of null/undefined")
            if isinstance(seq, str):
                seq = list(seq)
            for item in list(seq):
                it_env = Env(parent=env)
                if decl[0] == "decl":
                    self.bind_pattern(decl[2][0][0], item, it_env)
                else:  # bare identifier expression
                    self.assign_target(decl[1], item, env)
                try:
                    self.exec_stmt(body, it_env)
                except _Break:
                    break
                except _Continue:
                    continue
        elif kind == "while":
            while js_truthy(self.eval(stmt[1], env)):
                try:
                    self.exec_stmt(stmt[2], Env(parent=env))
                except _Break:
                    break
                except _Continue:
                    continue
        elif kind == "try":
            _, block, cparam, cblock, fblock = stmt
            try:
                self.exec_block(block, Env(parent=env))
            except _Control:
                raise
            except Exception as e:  # noqa: BLE001 — JS catch semantics
                if cblock is None:
                    raise
                cenv = Env(parent=env)
                if cparam is not None:
                    if isinstance(e, JsThrow):
                        value = e.value  # whatever the JS threw, verbatim
                    else:
                        # host/interpreter exceptions surface as an
                        # Error-shaped object so `e.message` / `e.name`
                        # work like they would in a real engine
                        value = {"message": str(e),
                                 "name": type(e).__name__,
                                 "stack": f"{type(e).__name__}: {e}"}
                    self.bind_pattern(cparam, value, cenv)
                self.exec_block(cblock, cenv)
            finally:
                if fblock is not None:
                    self.exec_block(fblock, Env(parent=env))
        elif kind == "throw":
            raise JsThrow(self.eval(stmt[1], env))
        elif kind == "break":
            raise _Break()
        elif kind == "continue":
            raise _Continue()
        elif kind == "import":
            if module_dir is None:
                raise JsError("import outside a module")
            target = os.path.realpath(os.path.join(module_dir, stmt[2]))
            mod = self.load_module(target)
            for exported, local in stmt[1]:
                if exported not in mod:
                    raise JsError(f"{stmt[2]} has no export {exported!r}")
                env.declare(local, mod[exported])
        elif kind == "export":
            if exports is None:
                raise JsError("export outside a module")
            inner = stmt[1]
            if inner[0] == "func":
                if inner[1] in env.vars:   # hoisted already
                    exports[inner[1]] = env.vars[inner[1]]
                else:
                    name, fn = self._declare_function(inner, env)
                    exports[name] = fn
            else:  # decl
                self.exec_stmt(inner, env)
                for target, _ in inner[2]:
                    for name in _pattern_names(target):
                        exports[name] = env.vars[name]
        elif kind == "empty":
            pass
        else:
            raise JsError(f"unknown statement kind {kind!r}")

    # ---- binding -------------------------------------------------------
    def bind_params(self, params, args, env):
        i = 0
        for param in params:
            if param[0] == "rest":
                self.bind_pattern(param[1], list(args[i:]), env)
                return
            pattern, default = param
            value = args[i] if i < len(args) else None
            if value is None and default is not None:
                value = self.eval(default, env)
            self.bind_pattern(pattern, value, env)
            i += 1

    def bind_pattern(self, pattern, value, env):
        kind = pattern[0]
        if kind == "ident":
            env.declare(pattern[1], value)
        elif kind == "arraypat":
            seq = value if isinstance(value, list) else list(value or [])
            for i, elem in enumerate(pattern[1]):
                if elem is None:
                    continue
                pat, default = elem
                v = seq[i] if i < len(seq) else None
                if v is None and default is not None:
                    v = self.eval(default, env)
                self.bind_pattern(pat, v, env)
        elif kind == "objpat":
            for key, target, default in pattern[1]:
                v = self.member_get(value, key, for_pattern=True)
                if v is None and default is not None:
                    v = self.eval(default, env)
                self.bind_pattern(target, v, env)
        else:
            raise JsError(f"bad binding pattern {kind!r}")

    def assign_target(self, target, value, env):
        kind = target[0]
        if kind == "ident":
            env.assign(target[1], value)
        elif kind == "member":
            obj = self.eval(target[1], env)
            self.member_set(obj, target[2], value)
        elif kind == "index":
            obj = self.eval(target[1], env)
            idx = self.eval(target[2], env)
            self.index_set(obj, idx, value)
        else:
            raise JsError("invalid assignment target")

    # ---- member / index access ----------------------------------------
    def member_get(self, obj, name, for_pattern=False):
        if obj is None:
            if for_pattern:
                raise JsError(f"cannot destructure {name!r} of undefined")
            raise JsError(f"cannot read properties of undefined (reading {name!r})")
        if isinstance(obj, dict):
            return obj.get(name)
        if isinstance(obj, list):
            if for_pattern:
                return None if name not in ("length",) else float(len(obj))
            return _array_members(self, obj, name)
        if isinstance(obj, str):
            if for_pattern:
                return float(len(obj)) if name == "length" else None
            return _string_members(obj, name)
        if isinstance(obj, bool):
            raise JsError(f"boolean has no member {name!r}")
        if isinstance(obj, (int, float)):
            return _number_members(obj, name)
        if isinstance(obj, JSPromise):
            if name == "then":
                return obj.then
            raise JsError(f"promise has no member {name!r}")
        # host object bridge
        try:
            return getattr(obj, name)
        except AttributeError:
            if for_pattern:
                return None
            raise JsError(
                f"{type(obj).__name__} has no member {name!r}") from None

    def member_set(self, obj, name, value):
        if obj is None:
            raise JsError(f"cannot set properties of undefined (setting {name!r})")
        if isinstance(obj, dict):
            obj[name] = value
            return
        if isinstance(obj, (list, str, int, float, bool)):
            raise JsError(f"cannot set member {name!r} on a primitive")
        setattr(obj, name, value)

    def index_get(self, obj, idx):
        if obj is None:
            raise JsError("cannot index undefined")
        if isinstance(obj, list):
            if isinstance(idx, (int, float)) and float(idx).is_integer():
                i = int(idx)
                return obj[i] if 0 <= i < len(obj) else None
            return self.member_get(obj, js_to_string(idx))
        if isinstance(obj, str):
            if isinstance(idx, (int, float)):
                i = int(idx)
                return obj[i] if 0 <= i < len(obj) else None
            return self.member_get(obj, js_to_string(idx))
        if isinstance(obj, dict):
            return obj.get(idx if isinstance(idx, str) else js_to_string(idx))
        return self.member_get(obj, js_to_string(idx))

    def index_set(self, obj, idx, value):
        if isinstance(obj, list):
            i = int(idx)
            while len(obj) <= i:
                obj.append(None)
            obj[i] = value
            return
        if isinstance(obj, dict):
            obj[idx if isinstance(idx, str) else js_to_string(idx)] = value
            return
        raise JsError("cannot index-assign this value")

    # ---- expressions ---------------------------------------------------
    def eval(self, node, env):
        kind = node[0]
        if kind == "num":
            return node[1]
        if kind == "str":
            return node[1]
        if kind == "bool":
            return node[1]
        if kind == "null":
            return None
        if kind == "ident":
            return env.lookup(node[1])
        if kind == "template":
            out = []
            for part_kind, part in node[1]:
                if part_kind == "str":
                    out.append(part[1])
                else:
                    out.append(js_to_string(self.eval(part, env)))
            return "".join(out)
        if kind == "array":
            out = []
            for elem in node[1]:
                if elem[0] == "spread":
                    spread = self.eval(elem[1], env)
                    out.extend(spread if isinstance(spread, list) else list(spread))
                else:
                    out.append(self.eval(elem, env))
            return out
        if kind == "object":
            obj = {}
            for key_node, value_expr in node[1]:
                if key_node[0] == "spread":
                    src = self.eval(value_expr, env)
                    if isinstance(src, dict):
                        obj.update(src)
                    continue
                if key_node[0] == "computed":
                    key = js_to_string(self.eval(key_node[1], env))
                else:
                    key = key_node[1]
                obj[key] = self.eval(value_expr, env)
            return obj
        if kind == "func":
            _, name, params, body, is_async, _ = node
            return JSFunction(self, params, body, env, name=name, is_async=is_async)
        if kind == "arrow":
            _, params, body, expr_body, is_async = node
            return JSFunction(self, params, body, env,
                              is_async=is_async, expr_body=expr_body)
        if kind == "member":
            return self.member_get(self.eval(node[1], env), node[2])
        if kind == "index":
            return self.index_get(self.eval(node[1], env), self.eval(node[2], env))
        if kind == "call":
            return self._eval_call(node, env)
        if kind == "new":
            callee = self.eval(node[1], env)
            args = self._eval_args(node[2], env)
            return callee(*args)
        if kind == "binop":
            return self._binop(node[1], self.eval(node[2], env),
                               self.eval(node[3], env))
        if kind == "logical":
            left = self.eval(node[2], env)
            op = node[1]
            if op == "&&":
                return self.eval(node[3], env) if js_truthy(left) else left
            if op == "||":
                return left if js_truthy(left) else self.eval(node[3], env)
            return left if left is not None else self.eval(node[3], env)  # ??
        if kind == "unary":
            op = node[1]
            if op == "typeof":
                try:
                    v = self.eval(node[2], env)
                except JsError:
                    return "undefined"
                return _typeof(v)
            v = self.eval(node[2], env)
            if op == "!":
                return not js_truthy(v)
            if op == "-":
                return -float(v)
            if op == "+":
                return float(v)
            if op == "~":
                return float(~int(_to_int32(v)))
            raise JsError(f"unknown unary {op!r}")
        if kind == "update":
            _, op, target, prefix = node
            ref = self._resolve_target(target, env)
            old = float(self._ref_read(ref, env))
            new = old + (1.0 if op == "++" else -1.0)
            self._ref_write(ref, new, env)
            return new if prefix else old
        if kind == "assign":
            _, op, target, value_expr = node
            if op == "=":
                value = self.eval(value_expr, env)
                self.assign_target(target, value, env)
                return value
            # compound forms evaluate the target's object/key exactly once
            ref = self._resolve_target(target, env)
            current = self._ref_read(ref, env)
            if op in ("&&=", "||=", "??="):
                take = {"&&=": js_truthy(current),
                        "||=": not js_truthy(current),
                        "??=": current is None}[op]
                if not take:
                    return current
                value = self.eval(value_expr, env)
            else:
                value = self._binop(op[:-1], current,
                                    self.eval(value_expr, env))
            self._ref_write(ref, value, env)
            return value
        if kind == "cond":
            return (self.eval(node[2], env) if js_truthy(self.eval(node[1], env))
                    else self.eval(node[3], env))
        if kind == "await":
            return _unwrap(self.eval(node[1], env))
        if kind == "seq":
            self.eval(node[1], env)
            return self.eval(node[2], env)
        raise JsError(f"unknown expression kind {kind!r}")

    def _resolve_target(self, target, env):
        """Evaluate a target's object/key expressions ONCE (JS reference
        semantics — `arr[f()] += 1` must call f exactly once)."""
        if target[0] == "ident":
            return ("ident", target[1], None)
        if target[0] == "member":
            return ("member", self.eval(target[1], env), target[2])
        if target[0] == "index":
            return ("index", self.eval(target[1], env),
                    self.eval(target[2], env))
        raise JsError("invalid assignment target")

    def _ref_read(self, ref, env):
        kind, a, b = ref
        if kind == "ident":
            return env.lookup(a)
        if kind == "member":
            return self.member_get(a, b)
        return self.index_get(a, b)

    def _ref_write(self, ref, value, env):
        kind, a, b = ref
        if kind == "ident":
            env.assign(a, value)
        elif kind == "member":
            self.member_set(a, b, value)
        else:
            self.index_set(a, b, value)

    def _eval_args(self, arg_nodes, env):
        args = []
        for a in arg_nodes:
            if a[0] == "spread":
                spread = self.eval(a[1], env)
                args.extend(spread if isinstance(spread, list) else list(spread))
            else:
                args.append(self.eval(a, env))
        return args

    def _eval_call(self, node, env):
        callee_node = node[1]
        if callee_node[0] == "member":
            obj = self.eval(callee_node[1], env)
            fn = self.member_get(obj, callee_node[2])
        elif callee_node[0] == "index":
            obj = self.eval(callee_node[1], env)
            fn = self.index_get(obj, self.eval(callee_node[2], env))
        else:
            fn = self.eval(callee_node, env)
        if fn is None or not callable(fn):
            desc = callee_node[2] if callee_node[0] == "member" else "value"
            raise JsError(f"{desc!r} is not a function")
        args = self._eval_args(node[2], env)
        return fn(*args)

    def _binop(self, op, a, b):
        if op == "+":
            if isinstance(a, str) or isinstance(b, str):
                return js_to_string(a) + js_to_string(b)
            return float(a) + float(b)
        if op == "-":
            return float(a) - float(b)
        if op == "*":
            return float(a) * float(b)
        if op == "/":
            fb = float(b)
            if fb == 0.0:
                fa = float(a)
                if fa == 0.0:
                    return float("nan")
                return math.copysign(float("inf"), fa) * math.copysign(1.0, fb)
            return float(a) / fb
        if op == "%":
            return float(math.fmod(float(a), float(b))) if float(b) != 0 else float("nan")
        if op == "**":
            return float(a) ** float(b)
        if op == "===":
            return _strict_eq(a, b)
        if op == "!==":
            return not _strict_eq(a, b)
        if op == "==":
            if a is None or b is None:
                return a is None and b is None
            return _strict_eq(a, b)
        if op == "!=":
            return not self._binop("==", a, b)
        if op in _REL_CMP:
            if isinstance(a, str) and isinstance(b, str):
                return _REL_CMP[op](a, b)
            return _REL_CMP[op](float(a), float(b))
        if op == "|":
            return float(int(_to_int32(a)) | int(_to_int32(b)))
        if op == "&":
            return float(int(_to_int32(a)) & int(_to_int32(b)))
        if op == "^":
            return float(int(_to_int32(a)) ^ int(_to_int32(b)))
        if op == "<<":
            return _to_int32(int(_to_int32(a)) << (int(_to_int32(b)) & 31))
        if op == ">>":
            return float(int(_to_int32(a)) >> (int(_to_int32(b)) & 31))
        if op == ">>>":
            return float((int(_to_int32(a)) & 0xFFFFFFFF) >> (int(_to_int32(b)) & 31))
        raise JsError(f"unknown operator {op!r}")


_REL_CMP = {
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
}


def _typeof(v) -> str:
    if v is None:
        return "undefined"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if callable(v):
        return "function"
    return "object"


def _pattern_names(pattern):
    kind = pattern[0]
    if kind == "ident":
        yield pattern[1]
    elif kind == "arraypat":
        for elem in pattern[1]:
            if elem is not None:
                yield from _pattern_names(elem[0])
    elif kind == "objpat":
        for _, target, _ in pattern[1]:
            yield from _pattern_names(target)
