"""Recursive-descent parser for the ES-2020 subset used by js/src.

Produces a tuple-based AST consumed by jsvm/interp.py. Coverage follows the
browser port's grammar (plus a margin for tests): modules (import/export),
function declarations and arrow functions (async included), destructuring
(array/object patterns, parameter defaults), template literals, spread
elements; optional chaining is not implemented. Statements: const/let/var,
if/else, classic for, for-of, while, try/catch/finally, throw, return,
break/continue, blocks.

Expression precedence (low→high): assignment, conditional, ``??``, ``||``,
``&&``, ``|``, ``^``, ``&``, equality, relational, shift, additive,
multiplicative, ``**``, unary/await, postfix update, call/member/index.

Framework-neutral copy of ``yolov3_tpu/jsvm/parser.py`` (the standard library
only; the port imports nothing of the JAX package). tests/test_torch_jsvm.py
pins its code, everything after this docstring, to its original.
"""

from __future__ import annotations

from .lexer import JsSyntaxError, tokenize

_ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "**=", "&&=", "||=", "??="}
_EQ_OPS = {"===", "!==", "==", "!="}
_REL_OPS = {"<", ">", "<=", ">="}
_SHIFT_OPS = {"<<", ">>", ">>>"}
_ADD_OPS = {"+", "-"}
_MUL_OPS = {"*", "/", "%"}
_UNARY_OPS = {"!", "-", "+", "~", "typeof"}


class Parser:
    def __init__(self, src: str):
        self.toks = tokenize(src)
        self.pos = 0

    # ---- token helpers -------------------------------------------------
    def peek(self, off=0):
        return self.toks[min(self.pos + off, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.pos]
        if t.kind != "eof":
            self.pos += 1
        return t

    def at(self, kind, value=None, off=0):
        t = self.peek(off)
        return t.kind == kind and (value is None or t.value == value)

    def at_punct(self, value, off=0):
        return self.at("punct", value, off)

    def at_kw(self, value, off=0):
        return self.at("keyword", value, off)

    def expect(self, kind, value=None):
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            raise JsSyntaxError(
                f"line {t.line}: expected {value or kind}, got {t.value!r}")
        return t

    def eat(self, kind, value=None):
        if self.at(kind, value):
            self.next()
            return True
        return False

    # ---- program / statements -----------------------------------------
    def parse_program(self):
        stmts = []
        while not self.at("eof"):
            stmts.append(self.parse_statement())
        return ("program", stmts)

    def parse_statement(self):
        if self.at_kw("import"):
            return self.parse_import()
        if self.at_kw("export"):
            return self.parse_export()
        if self.at_kw("const") or self.at_kw("let") or self.at_kw("var"):
            stmt = self.parse_var_decl()
            self.semicolon()
            return stmt
        if self.at_kw("function") or (self.at_kw("async") and self.at_kw("function", off=1)):
            return self.parse_function(statement=True)
        if self.at_kw("return"):
            self.next()
            value = None
            if not self.at_punct(";") and not self.at_punct("}"):
                value = self.parse_expression()
            self.semicolon()
            return ("return", value)
        if self.at_kw("if"):
            return self.parse_if()
        if self.at_kw("for"):
            return self.parse_for()
        if self.at_kw("while"):
            self.next()
            self.expect("punct", "(")
            test = self.parse_expression()
            self.expect("punct", ")")
            return ("while", test, self.parse_statement())
        if self.at_kw("try"):
            return self.parse_try()
        if self.at_kw("throw"):
            self.next()
            value = self.parse_expression()
            self.semicolon()
            return ("throw", value)
        if self.at_kw("break"):
            self.next()
            self.semicolon()
            return ("break",)
        if self.at_kw("continue"):
            self.next()
            self.semicolon()
            return ("continue",)
        if self.at_punct("{"):
            return self.parse_block()
        if self.at_punct(";"):
            self.next()
            return ("empty",)
        expr = self.parse_expression()
        self.semicolon()
        return ("expr", expr)

    def semicolon(self):
        # semicolons required except before '}' / EOF (the sources always
        # use them; this is a light ASI for test snippets)
        if not self.eat("punct", ";"):
            if not (self.at_punct("}") or self.at("eof")):
                t = self.peek()
                raise JsSyntaxError(f"line {t.line}: expected ';' before {t.value!r}")

    def parse_block(self):
        self.expect("punct", "{")
        stmts = []
        while not self.at_punct("}"):
            stmts.append(self.parse_statement())
        self.expect("punct", "}")
        return ("block", stmts)

    def parse_import(self):
        self.expect("keyword", "import")
        names = []  # (exported_name, local_name)
        if self.at("str"):
            source = self.next().value  # bare side-effect import
        else:
            self.expect("punct", "{")
            while not self.at_punct("}"):
                exported = self.next().value
                local = exported
                if self.eat("keyword", "as") or (self.at("ident", "as") and self.next()):
                    local = self.next().value
                names.append((exported, local))
                if not self.eat("punct", ","):
                    break
            self.expect("punct", "}")
            self.expect("keyword", "from")
            source = self.expect("str").value
        self.semicolon()
        return ("import", names, source)

    def parse_export(self):
        self.expect("keyword", "export")
        if self.at_kw("function") or self.at_kw("async"):
            fn = self.parse_function(statement=True)
            return ("export", fn)
        if self.at_kw("const") or self.at_kw("let") or self.at_kw("var"):
            decl = self.parse_var_decl()
            self.semicolon()
            return ("export", decl)
        raise JsSyntaxError(f"line {self.peek().line}: unsupported export form")

    def parse_var_decl(self):
        kind = self.next().value
        decls = []
        while True:
            target = self.parse_binding_target()
            init = None
            if self.eat("punct", "="):
                init = self.parse_assignment()
            decls.append((target, init))
            if not self.eat("punct", ","):
                break
        return ("decl", kind, decls)

    def parse_binding_target(self):
        if self.at_punct("["):
            self.next()
            elems = []
            while not self.at_punct("]"):
                if self.at_punct(","):
                    elems.append(None)  # hole
                    self.next()
                    continue
                pat = self.parse_binding_target()
                default = None
                if self.eat("punct", "="):
                    default = self.parse_assignment()
                elems.append((pat, default))
                if not self.at_punct("]"):
                    self.expect("punct", ",")
            self.expect("punct", "]")
            return ("arraypat", elems)
        if self.at_punct("{"):
            self.next()
            props = []  # (source_key, target_pattern, default)
            while not self.at_punct("}"):
                key = self.next().value
                target = ("ident", key)
                if self.eat("punct", ":"):
                    target = self.parse_binding_target()
                default = None
                if self.eat("punct", "="):
                    default = self.parse_assignment()
                props.append((key, target, default))
                if not self.at_punct("}"):
                    self.expect("punct", ",")
            self.expect("punct", "}")
            return ("objpat", props)
        t = self.next()
        if t.kind not in ("ident", "keyword"):
            raise JsSyntaxError(f"line {t.line}: bad binding target {t.value!r}")
        return ("ident", t.value)

    def parse_if(self):
        self.expect("keyword", "if")
        self.expect("punct", "(")
        test = self.parse_expression()
        self.expect("punct", ")")
        then = self.parse_statement()
        alt = None
        if self.eat("keyword", "else"):
            alt = self.parse_statement()
        return ("if", test, then, alt)

    def parse_for(self):
        self.expect("keyword", "for")
        self.expect("punct", "(")
        init = None
        if not self.at_punct(";"):
            if self.at_kw("const") or self.at_kw("let") or self.at_kw("var"):
                init = self.parse_var_decl()
            else:
                init = ("expr", self.parse_expression())
            if self.at_kw("of"):
                self.next()
                iterable = self.parse_expression()
                self.expect("punct", ")")
                return ("forof", init, iterable, self.parse_statement())
        self.expect("punct", ";")
        test = None if self.at_punct(";") else self.parse_expression()
        self.expect("punct", ";")
        update = None if self.at_punct(")") else self.parse_expression()
        self.expect("punct", ")")
        return ("for", init, test, update, self.parse_statement())

    def parse_try(self):
        self.expect("keyword", "try")
        block = self.parse_block()
        cparam = cblock = fblock = None
        if self.eat("keyword", "catch"):
            if self.eat("punct", "("):
                cparam = self.parse_binding_target()
                self.expect("punct", ")")
            cblock = self.parse_block()
        if self.eat("keyword", "finally"):
            fblock = self.parse_block()
        if cblock is None and fblock is None:
            raise JsSyntaxError("try without catch/finally")
        return ("try", block, cparam, cblock, fblock)

    # ---- functions -----------------------------------------------------
    def parse_function(self, statement: bool):
        is_async = self.eat("keyword", "async")
        self.expect("keyword", "function")
        name = None
        if self.at("ident"):
            name = self.next().value
        elif statement:
            raise JsSyntaxError("function statement requires a name")
        params = self.parse_params()
        body = self.parse_block()
        return ("func", name, params, body, is_async, statement)

    def parse_params(self):
        self.expect("punct", "(")
        params = []
        while not self.at_punct(")"):
            if self.eat("punct", "..."):
                params.append(("rest", self.parse_binding_target()))
            else:
                pat = self.parse_binding_target()
                default = None
                if self.eat("punct", "="):
                    default = self.parse_assignment()
                params.append((pat, default))
            if not self.at_punct(")"):
                self.expect("punct", ",")
        self.expect("punct", ")")
        return params

    # ---- expressions ---------------------------------------------------
    def parse_expression(self):
        expr = self.parse_assignment()
        while self.at_punct(","):
            self.next()
            expr = ("seq", expr, self.parse_assignment())
        return expr

    def parse_assignment(self):
        if self._arrow_ahead():
            return self.parse_arrow()
        left = self.parse_conditional()
        if self.at("punct") and self.peek().value in _ASSIGN_OPS:
            op = self.next().value
            if left[0] not in ("ident", "member", "index"):
                raise JsSyntaxError("invalid assignment target")
            right = self.parse_assignment()
            return ("assign", op, left, right)
        return left

    def _arrow_ahead(self):
        """Lookahead: does an arrow function start at the current token?"""
        i = self.pos
        toks = self.toks
        if toks[i].kind == "keyword" and toks[i].value == "async":
            i += 1
        if toks[i].kind == "ident" and toks[i + 1].kind == "punct" \
                and toks[i + 1].value == "=>":
            return True
        if not (toks[i].kind == "punct" and toks[i].value == "("):
            return False
        depth = 0
        while i < len(toks):
            t = toks[i]
            if t.kind == "punct":
                if t.value in "([{":
                    depth += 1
                elif t.value in ")]}":
                    depth -= 1
                    if depth == 0:
                        nxt = toks[i + 1]
                        return nxt.kind == "punct" and nxt.value == "=>"
            i += 1
        return False

    def parse_arrow(self):
        is_async = self.eat("keyword", "async")
        if self.at("ident"):
            params = [(("ident", self.next().value), None)]
        else:
            params = self.parse_params()
        self.expect("punct", "=>")
        if self.at_punct("{"):
            body = self.parse_block()
            expr_body = False
        else:
            body = self.parse_assignment()
            expr_body = True
        return ("arrow", params, body, expr_body, is_async)

    def parse_conditional(self):
        test = self.parse_nullish()
        if self.at_punct("?"):
            self.next()
            cons = self.parse_assignment()
            self.expect("punct", ":")
            alt = self.parse_assignment()
            return ("cond", test, cons, alt)
        return test

    def _binary(self, ops, sub):
        left = sub()
        while self.at("punct") and self.peek().value in ops:
            op = self.next().value
            left = ("binop", op, left, sub())
        return left

    def parse_nullish(self):
        left = self.parse_or()
        while self.at_punct("??"):
            self.next()
            left = ("logical", "??", left, self.parse_or())
        return left

    def parse_or(self):
        left = self.parse_and()
        while self.at_punct("||"):
            self.next()
            left = ("logical", "||", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_bitor()
        while self.at_punct("&&"):
            self.next()
            left = ("logical", "&&", left, self.parse_bitor())
        return left

    def parse_bitor(self):
        return self._binary({"|"}, self.parse_bitxor)

    def parse_bitxor(self):
        return self._binary({"^"}, self.parse_bitand)

    def parse_bitand(self):
        return self._binary({"&"}, self.parse_equality)

    def parse_equality(self):
        return self._binary(_EQ_OPS, self.parse_relational)

    def parse_relational(self):
        return self._binary(_REL_OPS, self.parse_shift)

    def parse_shift(self):
        return self._binary(_SHIFT_OPS, self.parse_additive)

    def parse_additive(self):
        return self._binary(_ADD_OPS, self.parse_multiplicative)

    def parse_multiplicative(self):
        return self._binary(_MUL_OPS, self.parse_exponent)

    def parse_exponent(self):
        left = self.parse_unary()
        if self.at_punct("**"):
            self.next()
            return ("binop", "**", left, self.parse_exponent())  # right-assoc
        return left

    def parse_unary(self):
        if self.at_kw("await"):
            self.next()
            return ("await", self.parse_unary())
        if self.at_kw("typeof"):
            self.next()
            return ("unary", "typeof", self.parse_unary())
        if self.at("punct") and self.peek().value in _UNARY_OPS:
            op = self.next().value
            return ("unary", op, self.parse_unary())
        if self.at_punct("++") or self.at_punct("--"):
            op = self.next().value
            return ("update", op, self.parse_unary(), True)
        return self.parse_postfix()

    def parse_postfix(self):
        expr = self.parse_call_member()
        if self.at_punct("++") or self.at_punct("--"):
            op = self.next().value
            return ("update", op, expr, False)
        return expr

    def parse_call_member(self):
        if self.eat("keyword", "new"):
            # `new` binds to the member chain only; the FIRST argument list
            # is the constructor call — later .m()/(…) apply to the result
            callee = self.parse_primary()
            while True:
                if self.at_punct("."):
                    self.next()
                    name = self.next()
                    callee = ("member", callee, name.value)
                elif self.at_punct("["):
                    self.next()
                    idx = self.parse_expression()
                    self.expect("punct", "]")
                    callee = ("index", callee, idx)
                else:
                    break
            args = self.parse_args() if self.at_punct("(") else []
            expr = ("new", callee, args)
        else:
            expr = self.parse_primary()
        while True:
            if self.at_punct("."):
                self.next()
                name = self.next()
                if name.kind not in ("ident", "keyword"):
                    raise JsSyntaxError(f"line {name.line}: bad member name")
                expr = ("member", expr, name.value)
            elif self.at_punct("["):
                self.next()
                idx = self.parse_expression()
                self.expect("punct", "]")
                expr = ("index", expr, idx)
            elif self.at_punct("("):
                expr = ("call", expr, self.parse_args())
            else:
                return expr

    def parse_args(self):
        self.expect("punct", "(")
        args = []
        while not self.at_punct(")"):
            if self.eat("punct", "..."):
                args.append(("spread", self.parse_assignment()))
            else:
                args.append(self.parse_assignment())
            if not self.at_punct(")"):
                self.expect("punct", ",")
        self.expect("punct", ")")
        return args

    def parse_primary(self):
        t = self.peek()
        if t.kind == "num":
            self.next()
            return ("num", t.value)
        if t.kind == "str":
            self.next()
            return ("str", t.value)
        if t.kind == "template":
            self.next()
            parts = []
            for kind, val in t.value:
                if kind == "str":
                    parts.append(("str", ("str", val)))
                else:
                    parts.append(("expr", Parser(val).parse_expression()))
            return ("template", parts)
        if t.kind == "ident":
            self.next()
            return ("ident", t.value)
        if t.kind == "keyword":
            if t.value in ("null", "undefined"):
                self.next()
                return ("null",)
            if t.value in ("true", "false"):
                self.next()
                return ("bool", t.value == "true")
            if t.value == "function" or (t.value == "async"
                                         and self.at_kw("function", off=1)):
                return self.parse_function(statement=False)
            raise JsSyntaxError(f"line {t.line}: unexpected keyword {t.value!r}")
        if t.kind == "punct":
            if t.value == "(":
                self.next()
                expr = self.parse_expression()
                self.expect("punct", ")")
                return expr
            if t.value == "[":
                self.next()
                elems = []
                while not self.at_punct("]"):
                    if self.eat("punct", "..."):
                        elems.append(("spread", self.parse_assignment()))
                    else:
                        elems.append(self.parse_assignment())
                    if not self.at_punct("]"):
                        self.expect("punct", ",")
                self.expect("punct", "]")
                return ("array", elems)
            if t.value == "{":
                return self.parse_object_literal()
        raise JsSyntaxError(f"line {t.line}: unexpected token {t.value!r}")

    def parse_object_literal(self):
        self.expect("punct", "{")
        props = []  # (key_node, value_expr) — key_node: ('str', k) or ('computed', expr) or ('spread', expr)
        while not self.at_punct("}"):
            if self.eat("punct", "..."):
                props.append((("spread",), self.parse_assignment()))
            elif self.at_punct("["):
                self.next()
                key = self.parse_assignment()
                self.expect("punct", "]")
                self.expect("punct", ":")
                props.append((("computed", key), self.parse_assignment()))
            else:
                t = self.next()
                if t.kind in ("ident", "keyword", "str"):
                    key = t.value
                elif t.kind == "num":
                    key = _num_key(t.value)
                else:
                    raise JsSyntaxError(f"line {t.line}: bad object key")
                if self.eat("punct", ":"):
                    props.append((("str", key), self.parse_assignment()))
                elif self.at_punct("("):
                    params = self.parse_params()
                    body = self.parse_block()
                    props.append((("str", key),
                                  ("func", key, params, body, False, False)))
                else:  # shorthand
                    props.append((("str", key), ("ident", key)))
            if not self.at_punct("}"):
                self.expect("punct", ",")
        self.expect("punct", "}")
        return ("object", props)


def _num_key(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else str(v)


def parse(src: str):
    return Parser(src).parse_program()


def parse_expr(src: str):
    p = Parser(src)
    e = p.parse_expression()
    p.expect("eof")
    return e
